// Hand-written Hopper (sm_90a) kernels for forward flash attention.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention,
// which walks the kv blocks of one (batch, q head, q block) output tile
// along a sequential grid axis and keeps the online-softmax state (running
// max m, denominator l, f32 accumulator) in VMEM scratch.  Per query row i
// against keys j of kv head h // g (GQA, no repeat of k / v):
//
//   s_ij = (q_i . k_j) * scale,  masked to -1e30 where j >= T, and under
//          `causal` where j > i, and with a `window` where j <= i - window
//   o_i  = sum_j softmax_j(s_ij) v_j,   written in q's type
//
// Layout: q and o are [B, H, S, dh], k and v [B, K, T, dh], each given by
// its three outer strides in elements (the head dim is contiguous), so the
// model passes its [B, S, H, dh] / [B, T, K, dh] tensors as transposed
// views without a copy.  Two routes, chosen by the inputs' type before the
// launch: bf16 inputs (every main path) run the tensor-core kernel, f32
// inputs (the parity sweeps) the f32 kernel.
//
// Training also asks for the softmax's log-sum-exp rows, lse_i = m_i +
// log(l_i) in the scaled-score units, which the backward kernels
// (flash_attention_bwd.cu) recompute the probabilities from.  The block
// already holds m and l of its rows, so it writes them when `lse` is not
// NULL ([B, H, S] f32, contiguous); a row that no key may see gets +inf,
// so every probability and gradient of it is 0.  Serving passes NULL, and
// the output is the same bit for bit either way (one kernel).
//
// What bounds it on this card: at yi-6b's prefill shape (B=8, H=32, K=4,
// S=T=256, dh=128, bf16, causal) the bytes are ~37.7 MB (q, o 16.8 MB each,
// k, v 2.1 MB each), 0.0113 ms at 3.35 TB/s, above the ~4.3 GFLOP of the
// causal products on the tensor cores (0.0043 ms); at recurrentgemma-2b's
// training shape (B=1, H=10, K=1, S=T=4096, dh=256, window 2048) the 64.4
// GFLOP of the visible pairs (0.065 ms) bound it.
//
// The bf16 route (flash_attention_tc_kernel) answers with the tensor cores
// and the TMA unit:
// * One block per (q tile of 64 rows, q head, batch): one consumer
//   warpgroup owns the 64 rows, a producer warp feeds it.  The producer
//   brings the q tile once and then each kv tile's k and v through a ring
//   of 2 stages in shared memory (cp.async.bulk.tensor, 128- or 64-byte
//   swizzle, one mbarrier per tile and stage that counts the bytes, and one
//   per stage that the consumer arrives on when it has read the stage).
// * s = q k^T is wgmma.mma_async m64n64k16 with both operands in shared
//   memory (bf16 x bf16 -> f32, exact products).  The online softmax runs on
//   the accumulator in registers in the f32 kernel's order (m' = max(m,
//   max_j s), alpha = exp(m - m'), l' = alpha l + sum p); the 4 threads of
//   a quad that share a row reduce its max by shuffles, and l at the end.
// * p is rounded to bf16 in registers and is the A operand of o += p v
//   (wgmma m64n{dh}k16, v read MN-major from shared memory), as the JAX
//   model rounds its probabilities to bf16 before p.v.
// * o = acc / max(l, 1e-30) is stored in bf16 from the accumulator.
// * A kv tile wholly above the diagonal or wholly left of the window is
//   never visited (the TPU kernel's block test, flash_attention.py:51-56,
//   on these tiles); tiles inside the mask skip the per-element test.
//   Ragged S and T: TMA fills rows past S or T with zeros, and the mask,
//   not the zeros, decides which keys weigh; rows past S are never stored.
//   A row that no key may see gets zeros (the TPU kernel returns a mean of
//   masked values there, the plain version NaN).
// * Shared memory: q 64 dh + 2 x (k + v) 64 dh bf16 (160 KB at dh 256, one
//   block an SM; 80 KB at dh 128, two).  Registers: the o accumulator is
//   dh / 2 floats a thread (128 at dh 256), s 32, p 16.
// * A head dim that is not a whole number of 64-column panels (80:
//   hubert-xlarge) keeps its tiles at the padded width DP (128, two
//   panels).  The tensor maps hold the true extent, so TMA fills columns
//   80-127 of every box with zeros and still counts the whole box's bytes
//   on the barrier; q k^T runs the 5 k16 steps of the true columns, p v
//   runs at N = DP over the zero columns of v, and the epilogue stores
//   the 80 true ones.  Shared memory and registers are dh 128's.
//
// The f32 route (flash_attention_kernel) is the first port's kernel: one
// block of 256 threads per (q tile of 64 rows, q head, batch); the q tile
// and each kv tile staged in shared memory as f32 (k rows padded to dh + 1
// floats), thread (ty, tx) of a 16 x 16 grid owning query rows ty + 16 r
// and keys / output columns tx + 16 c; products with explicit fmaf on the
// f32 pipes (the port builds every source with -fmad=false), since TF32
// tensor cores would not keep f32's digits; the probabilities go through
// shared memory from the score layout to the p.v layout.

#include "hopper.cuh"

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
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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
    case 80:
      return launch<T, 80>(q, k, v, o, lse, B, H, KH, S, T_len, st, scale,
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


// ------------------------------------------------------------ bf16 route

__device__ __forceinline__ bool visible(int i, int j, int T_len, int causal,
                                        int window) {
  return j < T_len && (!causal || (j <= i && (!window || j > i - window)));
}

template <int DH>
struct FwdTC {
  // The tiles' width: DH, or DH padded to whole 64-column panels.
  static constexpr int DP =
      DH <= 64 || DH % 64 == 0 ? DH : (DH + 63) / 64 * 64;
  using Tl = hopper::Tile<DP>;
  static constexpr int kStages = 2;
  static constexpr int kThreads = 160;   // a consumer warpgroup + a producer
  static constexpr int kK = Tl::BYTES;   // q tile at 0
  static constexpr int kV = kK + kStages * Tl::BYTES;
  static constexpr int kBar = kV + kStages * Tl::BYTES;
  static constexpr int kSmem = kBar + 8 * (1 + 3 * kStages) + 1024;
  static constexpr int kMinBlocks = DP == 256 ? 1 : 2;
};

template <int DH>
__global__ void __launch_bounds__(FwdTC<DH>::kThreads, FwdTC<DH>::kMinBlocks)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              __nv_bfloat16* __restrict__ o,
                              float* __restrict__ lse, int g, int S,
                              int T_len, Strides so, float scale, int causal,
                              int window) {
  using L = FwdTC<DH>;
  using Tl = typename L::Tl;
  constexpr int DP = L::DP;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + L::kStages;
  uint64_t* empty = v_full + L::kStages;

  const int q0 = blockIdx.x * 64;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // The kv tiles this q tile sees: causal stops at its last row's
  // diagonal; a window starts at the tile holding its first row's
  // earliest key.
  int k_begin = 0, k_end = T_len;
  if (causal) {
    k_end = min(T_len, q0 + 64);
    if (window) k_begin = max(0, q0 - window + 1) / 64 * 64;
  }
  const int n_tiles = (k_end - k_begin + 63) / 64;

  if (threadIdx.x == 0) {
    hopper::bar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      hopper::bar_init(k_full + s, 1);
      hopper::bar_init(v_full + s, 1);
      hopper::bar_init(empty + s, 4);    // one arrival per consumer warp
    }
    hopper::bar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {                       // the producer
    if (lane == 0) {
      hopper::bar_expect(q_full, Tl::BYTES);
      Tl::load(smem, &tq, q_full, q0, hh, bb);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % L::kStages;
        if (it >= L::kStages)
          hopper::bar_wait(empty + st, (it / L::kStages - 1) & 1);
        const int k0 = k_begin + it * 64;
        hopper::bar_expect(k_full + st, Tl::BYTES);
        Tl::load(smem + L::kK + st * Tl::BYTES, &tk, k_full + st, k0,
                 hh / g, bb);
        hopper::bar_expect(v_full + st, Tl::BYTES);
        Tl::load(smem + L::kV + st * Tl::BYTES, &tv, v_full + st, k0,
                 hh / g, bb);
      }
    }
    return;
  }

  // The consumer warpgroup: rows r0 + 8 i of the tile, r0 = 16 warp +
  // lane / 4; columns 8 j + 2 (lane % 4) + c of each 8-column group.
  const int t4 = lane % 4;
  const int row0 = q0 + warp * 16 + lane / 4;
  float acc[DP / 2], s[32];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) acc[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  hopper::bar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % L::kStages;
    const uint32_t ph = (it / L::kStages) & 1;
    const int k0 = k_begin + it * 64;
    const char* Ks = smem + L::kK + st * Tl::BYTES;
    const char* Vs = smem + L::kV + st * Tl::BYTES;

    hopper::bar_wait(k_full + st, ph);
    hopper::fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < DH / 16; ++k)
      hopper::wgmma_ss<0>(s, Tl::kmajor(smem, k), Tl::kmajor(Ks, k), k > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait();
    hopper::fence_regs(s);

    // A tile wholly inside the mask needs no per-element test.
    const bool inside =
        k0 + 64 <= T_len &&
        (!causal || (k0 + 63 <= q0 && (!window || k0 > q0 + 63 - window)));
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int iq = row0 + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int jk = k0 + 8 * j + 2 * t4 + c;
          const bool ok = inside || visible(iq, jk, T_len, causal, window);
          const float x = ok ? s[4 * j + 2 * i + c] * scale : kNegInf;
          s[4 * j + 2 * i + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int jk = k0 + 8 * j + 2 * t4 + c;
          const bool ok = inside || visible(iq, jk, T_len, causal, window);
          const float p = ok ? expf(s[4 * j + 2 * i + c] - m_new) : 0.0f;
          s[4 * j + 2 * i + c] = p;
          sum += p;
        }
      l[i] = alpha[i] * l[i] + sum;      // this thread's part of the row
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * j + 2 * i] *= alpha[i];
        acc[4 * j + 2 * i + 1] *= alpha[i];
      }
    uint32_t pa[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) hopper::a_fragment(s, k, pa[k]);

    hopper::bar_wait(v_full + st, ph);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hopper::wgmma_rs<1>(acc, pa[k], Tl::mnmajor(Vs, k, 0), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait();
    hopper::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hopper::bar_arrive(empty + st);
  }

  __nv_bfloat16* ob = o + bb * so.b + hh * so.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int iq = row0 + 8 * i;
    if (iq >= S) continue;
    const float den = fmaxf(lt, 1e-30f);
    __nv_bfloat16* orow = ob + iq * so.s + 2 * t4;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = hopper::pack_bf16(
          acc[4 * j + 2 * i] / den, acc[4 * j + 2 * i + 1] / den);
    if (lse != nullptr && t4 == 0) {
      lse[(static_cast<long long>(bb) * gridDim.y + hh) * S + iq] =
          lt > 0.0f ? m[i] + logf(lt) : __int_as_float(0x7f800000);
    }
  }
}

template <int DH>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int H, int KH, int S, int T_len,
              const long long* st, float scale, int causal, int window,
              void* stream) {
  constexpr int DP = FwdTC<DH>::DP;
  CUtensorMap tq, tk, tv;
  int err = hopper::make_map<DP>(&tq, q, B, H, S, st, DH);
  if (err == 0) err = hopper::make_map<DP>(&tk, k, B, KH, T_len, st + 3, DH);
  if (err == 0) err = hopper::make_map<DP>(&tv, v, B, KH, T_len, st + 6, DH);
  if (err != 0) return err;
  constexpr int smem = FwdTC<DH>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_tc_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Strides so{st[9], st[10], st[11]};
  flash_attention_tc_kernel<DH>
      <<<dim3((S + 63) / 64, H, B), FwdTC<DH>::kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, H / KH, S, T_len,
          so, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_tc(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int KH, int S, int T_len, int dh,
                const long long* st, float scale, int causal, int window,
                void* stream) {
  switch (dh) {
    case 32:
      return launch_tc<32>(q, k, v, o, lse, B, H, KH, S, T_len, st, scale,
                           causal, window, stream);
    case 64:
      return launch_tc<64>(q, k, v, o, lse, B, H, KH, S, T_len, st, scale,
                           causal, window, stream);
    case 80:
      return launch_tc<80>(q, k, v, o, lse, B, H, KH, S, T_len, st, scale,
                           causal, window, stream);
    case 128:
      return launch_tc<128>(q, k, v, o, lse, B, H, KH, S, T_len, st, scale,
                            causal, window, stream);
    case 256:
      return launch_tc<256>(q, k, v, o, lse, B, H, KH, S, T_len, st, scale,
                            causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// o = attention(q, k, v) on `stream`.  q, o: [B, H, S, dh]; k, v:
// [B, KH, T, dh], H % KH == 0; f32 (bf16 = 0: the f32 kernel) or bf16
// (bf16 = 1: the tensor-core kernel), all of one type.  `strides` holds 12
// element strides: (batch, head, row) of q, k, v and o in that order; the
// head dim is contiguous.  dh is 32, 64, 80, 128 or 256.  For bf16 the bases
// of q, k, v and their strides are multiples of 16 bytes (TMA).  `lse` is
// NULL or a contiguous [B, H, S] f32 output of the rows' log-sum-exp.
// Returns 0, a cudaError_t, or a tensor map's CUresult + 1000.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int H, int KH, int S,
                           int T_len, int dh, const long long* strides,
                           float scale, int causal, int window, int bf16,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bf16) {
    return dispatch_tc(q, k, v, o, lse, B, H, KH, S, T_len, dh, strides,
                       scale, causal, window, stream);
  }
  return dispatch<float>(q, k, v, o, lse, B, H, KH, S, T_len, dh, strides,
                         scale, causal, window, stream);
}

const char* flash_attention_error_string(int code) {
  return hopper::error_string(code);
}

}  // extern "C"
