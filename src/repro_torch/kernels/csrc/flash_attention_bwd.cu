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
// and delta are contiguous [B, H, S] f32.  dq comes out in q's type, dk
// and dv in k's.  Two routes, chosen by the inputs' type before the launch:
// bf16 (every training step) runs the tensor-core kernels, f32 (the parity
// sweeps) the f32 kernels.
//
// What bounds it on this card: at recurrentgemma-2b's training shape
// (B=1, H=10, K=1, S=T=4096, dh=256, window 2048, bf16) one call moves
// 92.6 MB (0.028 ms at 3.35 TB/s) and does 5 products over 6,292,480
// visible (i, j) pairs per head, 1.61e11 FLOP (0.163 ms on the bf16 tensor
// cores): it is bound by operations.  Both routes recompute p in the dq
// and in the dk/dv kernel (7 products, not 5): the price of writing every
// output element once, in a fixed order, with no atomics, so that a resumed
// run repeats an uninterrupted one bit for bit.
//
// The bf16 route answers with the tensor cores and the TMA unit:
// * delta: one warp per row, a shuffle sum; a launch of its own.
// * dq (dq_tc_kernel): one block per (q tile of 64 rows, q head, batch).
//   A producer warp brings q and do once and then each kv tile's k and v
//   through a ring of 2 stages (cp.async.bulk.tensor, 128- or 64-byte
//   swizzle, mbarriers that count the bytes and that the consumers arrive
//   on).  s = q k^T and dp = do v^T are wgmma.mma_async m64n64k16 from
//   shared memory; p = exp(s scale - lse) under the mask and ds = p (dp -
//   delta) scale in registers; ds rounded to bf16, then dq += ds k (k read
//   MN-major).  Below dh 256 one warpgroup does it all, ds going to the
//   next product as a register A operand.  At dh 256 the dq accumulator
//   (64 x 256 f32) would take 128 registers of every thread next to s and
//   dp, so two warpgroups split its columns: one computes s and p, the
//   other dp, p crosses in shared memory as f32 and ds comes back as a
//   swizzled bf16 tile that both read as the A operand of their half.
// * dk/dv (dkv_tc_kernel): one block owns a 64-row kv tile of a *kv* head,
//   with k and v loaded once, and walks (q head of the group, q tile)
//   items; the producer brings each item's q and do tiles through the
//   ring, and its lanes copy the item's lse and delta rows beside them.
//   s^T = k q^T and dp^T = v do^T (wgmma m64n64k16), p^T and ds^T as
//   above, then dv += p^T do and dk += ds^T q (q, do read MN-major), p^T
//   and ds^T in bf16.  The GQA group sums in the accumulators, so nothing
//   of size [B, H, T, dh] is written.  From dh 128 up two warpgroups split
//   the dk and dv columns (2 x 64 x dh f32 accumulators would not fit one
//   warpgroup's registers): one computes s^T and p^T, the other dp^T and
//   ds^T, and p (f32), p^T and ds^T (bf16, swizzled) cross in shared
//   memory, where both warpgroups read p^T and ds^T as A operands.
// * Grid: T / 64 x K x B blocks of dk/dv is 64 at recurrentgemma-2b's
//   shape (K = 1) on 132 SMs, so the wrapper may split each kv tile's
//   items into `splits` contiguous runs, one block each; each writes f32
//   partial dk and dv to a scratch [2, splits, B, K, T, dh], and a last
//   pass sums the runs in order and casts.  No atomics anywhere.
// * A tile wholly above the diagonal or wholly left of the window is never
//   visited (the TPU kernel's block test, flash_attention_bwd.py:86-90, on
//   these tiles), and tiles inside the mask skip the per-element test.
//   Ragged S and T: TMA fills rows past S or T with zeros, the mask and
//   lse = +inf past S zero their weights, and they are never stored.
// * Shared memory at dh 256: dq 217 KB (q, do, 2 stages of k, v, the p and
//   ds exchange), dk/dv 226 KB (k, v, 2 stages of q, do, the exchange, the
//   lse and delta rows): one block an SM.  Registers: where two consumer
//   warpgroups split the columns, the producer is a whole warpgroup that
//   hands its registers over (setmaxnreg: 40 for it, 232 for each
//   consumer thread, against the 168 a 384-thread block starts with), so
//   the accumulators do not spill.
//
// The f32 route is the first port's kernels: the delta kernel above; dq
// and dk/dv blocks of 256 threads staging tiles in shared memory as f32
// with rows padded to dh + 1 floats (kv tiles of 32 rows at dh 256),
// thread (ty, tx) of a 16 x 16 grid owning query rows (keys) ty + 16 r and
// keys (queries) and output columns tx + 16 c, products with explicit fmaf
// on the f32 pipes (TF32 tensor cores would not keep f32's digits), p and
// ds through shared memory from the score layout to the product layout;
// the score products accumulate over d in order exactly as the forward
// f32 kernel's, so p is that forward's softmax.

#include "hopper.cuh"

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


// ------------------------------------------------------------ bf16 route

__device__ __forceinline__ bool visible_tc(int i, int j, int T_len,
                                           int causal, int window) {
  return j < T_len && (!causal || (j <= i && (!window || j > i - window)));
}

// A (q tile, kv tile) pair wholly inside the mask (rows past S are zeroed
// by lse = +inf, so S does not enter).
__device__ __forceinline__ bool inside(int q0, int k0, int T_len, int causal,
                                       int window) {
  return k0 + 64 <= T_len &&
         (!causal || (k0 + 63 <= q0 && (!window || k0 > q0 + 63 - window)));
}

constexpr int kExP = 32 * 128 * 4;        // p exchange: [32][128] f32
// Registers a thread of a 384-thread block (two consumer warpgroups and a
// producer warpgroup, one block an SM): 40 for the producer, 232 for the
// consumers' accumulators (128 x 40 + 256 x 232 <= 65,536).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kExT = 64 * 64 * 2;         // a 64 x 64 bf16 swizzled tile

template <int DH>
struct DqTC {
  using Tl = hopper::Tile<DH>;
  static constexpr int kNWG = DH == 256 ? 2 : 1;  // consumer warpgroups
  static constexpr int kNC = DH / kNWG;           // dq columns of each
  static constexpr int kStages = 2;
  // One producer warp; with two consumer warpgroups a whole producer
  // warpgroup, so that it can hand its registers over (setmaxnreg).
  static constexpr int kThreads = 128 * kNWG + (kNWG == 2 ? 128 : 32);
  static constexpr int kDO = Tl::BYTES;           // q tile at 0
  static constexpr int kK = 2 * Tl::BYTES;
  static constexpr int kV = kK + kStages * Tl::BYTES;
  static constexpr int kP = kV + kStages * Tl::BYTES;
  static constexpr int kDS = kP + (kNWG == 2 ? kExP : 0);
  static constexpr int kBar = kDS + (kNWG == 2 ? kExT : 0);
  static constexpr int kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(DqTC<DH>::kThreads, DH >= 128 ? 1 : 2)
    dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int g, int S, int T_len,
                 Strides sdq, float scale, int causal, int window) {
  using L = DqTC<DH>;
  using Tl = hopper::Tile<DH>;
  using T64 = hopper::Tile<64>;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* qo_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kv_full = qo_full + 1;
  uint64_t* empty = kv_full + L::kStages;

  const int q0 = blockIdx.x * 64;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int k_begin = 0, k_end = T_len;
  if (causal) {
    k_end = min(T_len, q0 + 64);
    if (window) k_begin = max(0, q0 - window + 1) / 64 * 64;
  }
  const int n_tiles = (k_end - k_begin + 63) / 64;

  if (threadIdx.x == 0) {
    hopper::bar_init(qo_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      hopper::bar_init(kv_full + s, 1);
      hopper::bar_init(empty + s, 4 * L::kNWG);
    }
    hopper::bar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * L::kNWG) {             // the producer
    if constexpr (L::kNWG == 2) hopper::regs_release<kProducerRegs>();
    if (warp == 4 * L::kNWG && lane == 0) {
      hopper::bar_expect(qo_full, 2 * Tl::BYTES);
      Tl::load(smem, &tq, qo_full, q0, hh, bb);
      Tl::load(smem + L::kDO, &tdo, qo_full, q0, hh, bb);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % L::kStages;
        if (it >= L::kStages)
          hopper::bar_wait(empty + st, (it / L::kStages - 1) & 1);
        const int k0 = k_begin + it * 64;
        hopper::bar_expect(kv_full + st, 2 * Tl::BYTES);
        Tl::load(smem + L::kK + st * Tl::BYTES, &tk, kv_full + st, k0,
                 hh / g, bb);
        Tl::load(smem + L::kV + st * Tl::BYTES, &tv, kv_full + st, k0,
                 hh / g, bb);
      }
    }
    return;
  }

  if constexpr (L::kNWG == 2) hopper::regs_claim<kConsumerRegs>();
  const int wg = warp / 4;               // consumer warpgroup
  const int tid = threadIdx.x % 128;
  const int t4 = lane % 4;
  const int r0 = (warp % 4) * 16 + lane / 4;   // tile row of i = 0
  const long long row_base = (static_cast<long long>(bb) * gridDim.y + hh) * S;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int iq = q0 + r0 + 8 * i;
    lse_r[i] = iq < S ? lse[row_base + iq] : __int_as_float(0x7f800000);
    delta_r[i] = iq < S ? delta[row_base + iq] : 0.0f;
  }
  float acc[L::kNC / 2], s[32], dp[32];
#pragma unroll
  for (int e = 0; e < L::kNC / 2; ++e) acc[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.0f;
  float* ex_p = reinterpret_cast<float*>(smem + L::kP);
  char* ex_ds = smem + L::kDS;
  hopper::bar_wait(qo_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % L::kStages;
    const int k0 = k_begin + it * 64;
    const char* Ks = smem + L::kK + st * Tl::BYTES;
    const char* Vs = smem + L::kV + st * Tl::BYTES;
    const bool in = inside(q0, k0, T_len, causal, window);
    hopper::bar_wait(kv_full + st, (it / L::kStages) & 1);

    if (L::kNWG == 1 || wg == 0) {       // s = q k^T -> p
      hopper::fence_regs(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < DH / 16; ++k)
        hopper::wgmma_ss<0>(s, Tl::kmajor(smem, k), Tl::kmajor(Ks, k),
                            k > 0);
      hopper::wgmma_commit();
    }
    if (L::kNWG == 1 || wg == 1) {       // dp = do v^T
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < DH / 16; ++k)
        hopper::wgmma_ss<0>(dp, Tl::kmajor(smem + L::kDO, k),
                            Tl::kmajor(Vs, k), k > 0);
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    if (L::kNWG == 1 || wg == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            const bool ok = in || visible_tc(q0 + r0 + 8 * i,
                                             k0 + 8 * j + 2 * t4 + c, T_len,
                                             causal, window);
            s[e] = ok ? expf(s[e] * scale - lse_r[i]) : 0.0f;
          }
    }

    if constexpr (L::kNWG == 1) {
      // ds in registers, then dq += ds k with ds as the A operand.
      uint32_t da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            dp[e] = s[e] * (dp[e] - delta_r[i]) * scale;
          }
#pragma unroll
      for (int k = 0; k < 4; ++k) hopper::a_fragment(dp, k, da[k]);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        hopper::wgmma_rs<1>(acc, da[k], Tl::mnmajor(Ks, k, 0), 1);
    } else {
      // p crosses to the dp warpgroup, ds comes back as a bf16 tile that
      // both read for their half of dq's columns.
      if (wg == 0) {
#pragma unroll
        for (int e = 0; e < 32; ++e) ex_p[e * 128 + tid] = s[e];
      }
      hopper::named_sync(1, 256);
      if (wg == 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i;
            const float d0 =
                ex_p[e * 128 + tid] * (dp[e] - delta_r[i]) * scale;
            const float d1 =
                ex_p[(e + 1) * 128 + tid] * (dp[e + 1] - delta_r[i]) * scale;
            *reinterpret_cast<uint32_t*>(
                ex_ds + hopper::swizzled64(r0 + 8 * i, 8 * j + 2 * t4)) =
                hopper::pack_bf16(d0, d1);
          }
        hopper::fence_async_smem();
      }
      hopper::named_sync(2, 256);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        hopper::wgmma_ss<1>(acc, T64::kmajor(ex_ds, k),
                            Tl::mnmajor(Ks, k, wg * L::kNC), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait();
    hopper::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hopper::bar_arrive(empty + st);
  }

  __nv_bfloat16* db = dq + bb * sdq.b + hh * sdq.h + wg * L::kNC + 2 * t4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int iq = q0 + r0 + 8 * i;
    if (iq >= S) continue;
#pragma unroll
    for (int j = 0; j < L::kNC / 8; ++j)
      *reinterpret_cast<uint32_t*>(db + iq * sdq.s + 8 * j) =
          hopper::pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

template <int DH>
struct DkvTC {
  using Tl = hopper::Tile<DH>;
  static constexpr int kNWG = DH >= 128 ? 2 : 1;  // consumer warpgroups
  static constexpr int kNC = DH / kNWG;           // dk, dv columns of each
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128 * kNWG + (kNWG == 2 ? 128 : 32);
  static constexpr int kV = Tl::BYTES;            // k tile at 0
  static constexpr int kQ = 2 * Tl::BYTES;
  static constexpr int kDO = kQ + kStages * Tl::BYTES;
  static constexpr int kP = kDO + kStages * Tl::BYTES;
  static constexpr int kPT = kP + (kNWG == 2 ? kExP : 0);
  static constexpr int kDS = kPT + (kNWG == 2 ? kExT : 0);
  static constexpr int kRows = kDS + (kNWG == 2 ? kExT : 0);
  static constexpr int kBar = kRows + kStages * 2 * 64 * 4;
  static constexpr int kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(DkvTC<DH>::kThreads, 1)
    dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
                  int B, int H, int g, int S, int T_len, int splits,
                  Strides sdk, Strides sdv, float scale, int causal,
                  int window) {
  using L = DkvTC<DH>;
  using Tl = hopper::Tile<DH>;
  using T64 = hopper::Tile<64>;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + L::kStages;
  float* rows = reinterpret_cast<float*>(smem + L::kRows);

  const int k0 = blockIdx.x * 64;
  const int kvh = blockIdx.y;
  const int bb = blockIdx.z / splits;
  const int sp = blockIdx.z % splits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // The q tiles that see this kv tile: causal starts at its first key's
  // diagonal and, with a window, ends past its last key's latest query.
  // The items (q head of the group, q tile) are split into `splits` runs.
  int q_begin = 0, q_end = S;
  if (causal) {
    q_begin = k0;
    if (window) q_end = min(S, k0 + 63 + window);
  }
  const int n_qt = q_end > q_begin ? (q_end - q_begin + 63) / 64 : 0;
  const int items = g * n_qt;
  const int i_begin = static_cast<int>(static_cast<long long>(sp) * items /
                                       splits);
  const int i_end = static_cast<int>(static_cast<long long>(sp + 1) * items /
                                     splits);

  if (threadIdx.x == 0) {
    hopper::bar_init(kv_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      hopper::bar_init(full + s, 1);
      hopper::bar_init(empty + s, 4 * L::kNWG);
    }
    hopper::bar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * L::kNWG) {             // the producer
    if constexpr (L::kNWG == 2) hopper::regs_release<kProducerRegs>();
    if (warp > 4 * L::kNWG) return;
    if (lane == 0) {
      hopper::bar_expect(kv_full, 2 * Tl::BYTES);
      Tl::load(smem, &tk, kv_full, k0, kvh, bb);
      Tl::load(smem + L::kV, &tv, kv_full, k0, kvh, bb);
    }
    for (int n = 0; i_begin + n < i_end; ++n) {
      const int st = n % L::kStages;
      if (n >= L::kStages)
        hopper::bar_wait(empty + st, (n / L::kStages - 1) & 1);
      const int item = i_begin + n;
      const int hh = kvh * g + item / n_qt;
      const int q0 = q_begin + (item % n_qt) * 64;
      const long long row_base = (static_cast<long long>(bb) * H + hh) * S;
      float* r = rows + st * 128;
      for (int e = lane; e < 64; e += 32) {
        const int iq = q0 + e;
        r[e] = iq < S ? lse[row_base + iq] : __int_as_float(0x7f800000);
        r[64 + e] = iq < S ? delta[row_base + iq] : 0.0f;
      }
      __syncwarp();
      if (lane == 0) {
        hopper::bar_expect(full + st, 2 * Tl::BYTES);
        Tl::load(smem + L::kQ + st * Tl::BYTES, &tq, full + st, q0, hh, bb);
        Tl::load(smem + L::kDO + st * Tl::BYTES, &tdo, full + st, q0, hh,
                 bb);
      }
    }
    return;
  }

  if constexpr (L::kNWG == 2) hopper::regs_claim<kConsumerRegs>();
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int t4 = lane % 4;
  const int r0 = (warp % 4) * 16 + lane / 4;   // tile row (key) of i = 0
  float acc_k[L::kNC / 2], acc_v[L::kNC / 2], s[32], dp[32];
#pragma unroll
  for (int e = 0; e < L::kNC / 2; ++e) acc_k[e] = acc_v[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.0f;
  float* ex_p = reinterpret_cast<float*>(smem + L::kP);
  char* ex_pt = smem + L::kPT;
  char* ex_ds = smem + L::kDS;
  hopper::bar_wait(kv_full, 0);

  for (int n = 0; i_begin + n < i_end; ++n) {
    const int st = n % L::kStages;
    const int item = i_begin + n;
    const int q0 = q_begin + (item % n_qt) * 64;
    const char* Qs = smem + L::kQ + st * Tl::BYTES;
    const char* Os = smem + L::kDO + st * Tl::BYTES;
    const float* r = rows + st * 128;    // lse, then delta, of the q tile
    const bool in = inside(q0, k0, T_len, causal, window);
    hopper::bar_wait(full + st, (n / L::kStages) & 1);

    if (L::kNWG == 1 || wg == 0) {       // s^T = k q^T -> p^T
      hopper::fence_regs(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < DH / 16; ++k)
        hopper::wgmma_ss<0>(s, Tl::kmajor(smem, k), Tl::kmajor(Qs, k),
                            k > 0);
      hopper::wgmma_commit();
    }
    if (L::kNWG == 1 || wg == 1) {       // dp^T = v do^T
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < DH / 16; ++k)
        hopper::wgmma_ss<0>(dp, Tl::kmajor(smem + L::kV, k),
                            Tl::kmajor(Os, k), k > 0);
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    if (L::kNWG == 1 || wg == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            const int cq = 8 * j + 2 * t4 + c;
            const bool ok = in || visible_tc(q0 + cq, k0 + r0 + 8 * i, T_len,
                                             causal, window);
            s[e] = ok ? expf(s[e] * scale - r[cq]) : 0.0f;
          }
    }

    if constexpr (L::kNWG == 1) {
      // p^T and ds^T in registers, the A operands of dv and dk.
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            dp[e] = s[e] * (dp[e] - r[64 + 8 * j + 2 * t4 + c]) * scale;
          }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        hopper::a_fragment(s, k, pa[k]);
        hopper::a_fragment(dp, k, da[k]);
      }
      hopper::fence_regs(acc_v);
      hopper::fence_regs(acc_k);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        hopper::wgmma_rs<1>(acc_v, pa[k], Tl::mnmajor(Os, k, 0), 1);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        hopper::wgmma_rs<1>(acc_k, da[k], Tl::mnmajor(Qs, k, 0), 1);
    } else {
      // p (f32) crosses to the dp warpgroup, p^T and ds^T (bf16) go to
      // shared memory, where both read them for their half of the columns.
      hopper::named_sync(1, 256);        // both done with the last tiles
      if (wg == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i;
            ex_p[e * 128 + tid] = s[e];
            ex_p[(e + 1) * 128 + tid] = s[e + 1];
            *reinterpret_cast<uint32_t*>(
                ex_pt + hopper::swizzled64(r0 + 8 * i, 8 * j + 2 * t4)) =
                hopper::pack_bf16(s[e], s[e + 1]);
          }
        hopper::fence_async_smem();
      }
      hopper::named_sync(2, 256);
      if (wg == 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i;
            const int cq = 8 * j + 2 * t4;
            const float d0 =
                ex_p[e * 128 + tid] * (dp[e] - r[64 + cq]) * scale;
            const float d1 = ex_p[(e + 1) * 128 + tid] *
                             (dp[e + 1] - r[64 + cq + 1]) * scale;
            *reinterpret_cast<uint32_t*>(
                ex_ds + hopper::swizzled64(r0 + 8 * i, cq)) =
                hopper::pack_bf16(d0, d1);
          }
        hopper::fence_async_smem();
      }
      hopper::named_sync(3, 256);
      hopper::fence_regs(acc_v);
      hopper::fence_regs(acc_k);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        hopper::wgmma_ss<1>(acc_v, T64::kmajor(ex_pt, k),
                            Tl::mnmajor(Os, k, wg * L::kNC), 1);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        hopper::wgmma_ss<1>(acc_k, T64::kmajor(ex_ds, k),
                            Tl::mnmajor(Qs, k, wg * L::kNC), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait();
    hopper::fence_regs(acc_v);
    hopper::fence_regs(acc_k);
    __syncwarp();
    if (lane == 0) hopper::bar_arrive(empty + st);
  }

  // dk, dv rows r0 + 8 i of the tile, columns wg * kNC + 8 j + 2 t4 + c:
  // cast and stored, or f32 partials of this run.
  const int KH = gridDim.y;
  const long long n_all = static_cast<long long>(B) * KH * T_len * DH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int jk = k0 + r0 + 8 * i;
    if (jk >= T_len) continue;
    const int col = wg * L::kNC + 2 * t4;
    if (part != nullptr) {
      float* pk = part + (static_cast<long long>(sp) * n_all +
                          ((static_cast<long long>(bb) * KH + kvh) * T_len +
                           jk) * DH + col);
      float* pv = pk + splits * n_all;
#pragma unroll
      for (int j = 0; j < L::kNC / 8; ++j) {
        *reinterpret_cast<float2*>(pk + 8 * j) =
            make_float2(acc_k[4 * j + 2 * i], acc_k[4 * j + 2 * i + 1]);
        *reinterpret_cast<float2*>(pv + 8 * j) =
            make_float2(acc_v[4 * j + 2 * i], acc_v[4 * j + 2 * i + 1]);
      }
    } else {
      __nv_bfloat16* ok = dk + bb * sdk.b + kvh * sdk.h + jk * sdk.s + col;
      __nv_bfloat16* ov = dv + bb * sdv.b + kvh * sdv.h + jk * sdv.s + col;
#pragma unroll
      for (int j = 0; j < L::kNC / 8; ++j) {
        *reinterpret_cast<uint32_t*>(ok + 8 * j) = hopper::pack_bf16(
            acc_k[4 * j + 2 * i], acc_k[4 * j + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(ov + 8 * j) = hopper::pack_bf16(
            acc_v[4 * j + 2 * i], acc_v[4 * j + 2 * i + 1]);
      }
    }
  }
}

// dk, dv = the sums of the runs' partials ([2, splits, B, K, T, dh] f32),
// in run order, cast to bf16.
__global__ void __launch_bounds__(256)
    dkv_reduce_kernel(const float* __restrict__ part,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int splits, int KH,
                      int T_len, int dh, long long n_all, Strides sdk,
                      Strides sdv) {
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < n_all;
       e += static_cast<long long>(gridDim.x) * 256) {
    float sk = 0.0f, sv = 0.0f;
    for (int sp = 0; sp < splits; ++sp) {
      sk += part[sp * n_all + e];
      sv += part[(splits + sp) * n_all + e];
    }
    const int d = static_cast<int>(e % dh);
    const long long row = e / dh;
    const int t = static_cast<int>(row % T_len);
    const int kh = static_cast<int>((row / T_len) % KH);
    const long long b = row / T_len / KH;
    dk[b * sdk.b + kh * sdk.h + t * sdk.s + d] = __float2bfloat16_rn(sk);
    dv[b * sdv.b + kh * sdv.h + t * sdv.s + d] = __float2bfloat16_rn(sv);
  }
}

template <int DH>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, float* part, int splits, int B, int H,
              int KH, int S, int T_len, const long long* st, float scale,
              int causal, int window, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  CUtensorMap tq, tk, tv, tdo;
  int err = hopper::make_map<DH>(&tq, q, B, H, S, st);
  if (err == 0) err = hopper::make_map<DH>(&tk, k, B, KH, T_len, st + 3);
  if (err == 0) err = hopper::make_map<DH>(&tv, v, B, KH, T_len, st + 6);
  if (err == 0) err = hopper::make_map<DH>(&tdo, dout, B, H, S, st + 12);
  if (err != 0) return err;
  const Strides so{st[9], st[10], st[11]}, sdo{st[12], st[13], st[14]},
      sdq{st[15], st[16], st[17]}, sdk{st[18], st[19], st[20]},
      sdv{st[21], st[22], st[23]};

  delta_kernel<bf16><<<dim3((S + kThreads / 32 - 1) / (kThreads / 32), H, B),
                       kThreads, 0, stream>>>(static_cast<const bf16*>(o),
                                              static_cast<const bf16*>(dout),
                                              delta, S, DH, so, sdo);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  constexpr int dq_smem = DqTC<DH>::kSmem;
  e = cudaFuncSetAttribute(dq_tc_kernel<DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dq_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_tc_kernel<DH><<<dim3((S + 63) / 64, H, B), DqTC<DH>::kThreads, dq_smem,
                     stream>>>(tq, tk, tv, tdo, lse, delta,
                               static_cast<bf16*>(dq), H / KH, S, T_len, sdq,
                               scale, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  constexpr int dkv_smem = DkvTC<DH>::kSmem;
  e = cudaFuncSetAttribute(dkv_tc_kernel<DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dkv_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_tc_kernel<DH><<<dim3((T_len + 63) / 64, KH, B * splits),
                      DkvTC<DH>::kThreads, dkv_smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), splits > 1 ? part : nullptr, B, H, H / KH, S,
      T_len, splits, sdk, sdv, scale, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);

  const long long n_all = static_cast<long long>(B) * KH * T_len * DH;
  const int blocks = static_cast<int>(
      n_all / 256 + 1 < 4096 ? n_all / 256 + 1 : 4096);
  dkv_reduce_kernel<<<blocks, 256, 0, stream>>>(
      part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), splits, KH,
      T_len, DH, n_all, sdk, sdv);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_tc(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, float* part, int splits, int B, int H,
                int KH, int S, int T_len, int dh, const long long* st,
                float scale, int causal, int window, cudaStream_t stream) {
#define REPRO_FA_BWD_TC(DH)                                                  \
  launch_tc<DH>(q, k, v, o, dout, lse, delta, dq, dk, dv, part, splits, B,  \
                H, KH, S, T_len, st, scale, causal, window, stream)
  switch (dh) {
    case 32:
      return REPRO_FA_BWD_TC(32);
    case 64:
      return REPRO_FA_BWD_TC(64);
    case 128:
      return REPRO_FA_BWD_TC(128);
    case 256:
      return REPRO_FA_BWD_TC(256);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FA_BWD_TC
}

}  // namespace

extern "C" {

// (dq, dk, dv) of attention on `stream`: a delta, a dq and a dk/dv launch
// (and, for bf16 with splits > 1, the partials' sum).  q, o, do, dq:
// [B, H, S, dh]; k, v, dk, dv: [B, KH, T, dh], H % KH == 0; f32 (bf16 = 0:
// the f32 kernels) or bf16 (bf16 = 1: the tensor-core kernels), all of one
// type.  `strides` holds 24 element strides: (batch, head, row) of q, k,
// v, o, do, dq, dk and dv in that order; the head dim is contiguous.  For
// bf16 the bases of q, k, v, do and their strides are multiples of 16
// bytes (TMA).  lse (the forward's) and delta (scratch, written here) are
// contiguous [B, H, S] f32.  dh is 32, 64, 128 or 256.  bf16 only: the
// dk/dv items of each kv tile run in `splits` blocks, whose f32 partials
// go to `part` ([2, splits, B, KH, T, dh], unused when splits = 1).
// Returns 0, a cudaError_t, or a tensor map's CUresult + 1000.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv, float* part, int splits,
                               int B, int H, int KH, int S, int T_len,
                               int dh, const long long* strides, float scale,
                               int causal, int window, int bf16, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dispatch_tc(q, k, v, o, dout, lse, delta, dq, dk, dv, part,
                       splits, B, H, KH, S, T_len, dh, strides, scale,
                       causal, window, s);
  }
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KH,
                         S, T_len, dh, strides, scale, causal, window, s);
}

const char* flash_attention_bwd_error_string(int code) {
  return hopper::error_string(code);
}

}  // extern "C"
