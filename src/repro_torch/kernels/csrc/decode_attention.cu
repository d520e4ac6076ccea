// Hand-written Hopper (sm_90a) kernels for single-token decode attention.
//
// Replace the TPU kernel repro/kernels/decode_attention.py::decode_attention,
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
// At the yi-6b serving shape (B=8, H=32, K=4, 257 valid rows, dh=128,
// bf16) that is 2.1 MB each of k and v plus q and o, 4.34 MB in all,
// 0.0013 ms at 3.35 TB/s; recurrentgemma-2b's (H=10, K=1, dh=256) 2.19 MB,
// 0.00065 ms.  The operations (2 x 2 x H x 257 x dh per batch row) take
// far less even on the f32 pipes, so the kernel stays on the CUDA cores
// in f32.  Bytes this small are read only as fast as there are blocks in
// flight to read them: one block per (kv head, batch) gives 32 and 8
// blocks on 132 SMs.
//
// What the design does: split each row's valid run across blocks
// (flash-decoding).  The grid is (splits, K, B); the wrapper picks
// `splits` from T, B * K and the SM count, never from the lengths (which
// would cost the host a synchronisation every step).  Block `split` of row
// b reads lengths[b] itself and takes run positions [split * per,
// min(len, (split + 1) * per)), per = ceil(len / splits): every split of a
// row gets the same share, whatever the length.  A block of 128 threads
// (4 warps) stages the share in tiles of 32 keys through cp.async, 16
// bytes a thread (8 bf16 or 4 f32), double-buffered so the next tile's
// loads are in flight while this tile is used; the group's q rows sit in
// shared memory as f32.  Warp w owns the group's rows i = w, w + 4, ...
// Scores: lane j takes key j of the tile and dots it with each of the
// warp's rows, 16 bytes of k at a time against q read by all lanes at
// once (one broadcast), so the 32 keys of a tile go in parallel and no
// shuffle sits on the dot product's path.  Then per row, key j's score in
// lane j: the tile's max and the exponentials' sum by warp shuffles, the
// running (m, l) update, and P.V, where each lane accumulates its
// contiguous dh / 32 slice of the row's output in registers.
// Rows past the share are never read.  With one split the block writes o
// itself.  With more, it writes its partial (m, l, acc[g][dh]) in f32, a
// split that holds no valid row m = -1e30, l = 0 and acc = 0, and a
// second kernel merges the splits of every (b, h) in order s = 0, 1, ...:
// M = max_s m_s, w_s = exp(m_s - M), L = sum_s w_s l_s, o = sum_s w_s
// acc_s / max(L, 1e-30).  No atomics: two calls are bit-equal, and a
// length of 0 gives zeros (-1e30, not -inf, so that exp(m_s - M) is
// exp(0) and never NaN).
//
// Scratch: the partials are [B, K, splits, g, dh + 2] f32, B * H * splits
// * (dh + 2) * 4 bytes, written once and read once.  The wrapper keeps
// them within the bytes of the caches' T rows (2 * B * K * T * dh * esize):
// at the serving shapes (T = 512, bf16) 0.67 MB against 8.39 MB (yi-6b,
// 5 splits) and 1.40 MB against 4.19 MB (recurrentgemma-2b, 17 splits).
//
// Two earlier versions were slower on the card: lanes splitting dh with
// a shuffle butterfly per key put five dependent shuffles per key and row
// in series, and a row count per warp known only at run time left every
// 16-byte chunk's loads behind a branch per row.  So the rows a warp
// computes, ceil(g / 4), are a template argument; a row past g repeats
// row g - 1 and is not written.
//
// Numerics: f32 scores and accumulation (explicit fmaf; the port builds
// every source with -fmad=false); the dot product of a key keeps four
// partial sums, chunk c of 16 bytes into sum c mod 4, each left to right,
// then (s0 + s1) + (s2 + s3); softmax in the TPU kernel's order per
// tile: m' = max(m, max_j s), alpha = exp(m - m'), l' = alpha l + sum p,
// acc' = alpha acc + sum_j p_j v_j, o = acc / max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;          // keys per tile: one per lane
constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxOut = 4096;    // g * dh of a group, at most
constexpr int kMaxGroup = 32;    // g, at most
constexpr int kMaxSplits = 64;   // blocks a row's run is split over
constexpr float kNegInf = -1e30f;
static_assert(kBK == kWarp, "key j of a tile is lane j's");

// q rows each warp computes for a group of g: ceil(g / kWarps), taken
// as 1, 2, 3, 4 or 8 (g <= kMaxGroup = 32).
__host__ __device__ constexpr int rows_of(int g) {
  return g <= 4 ? 1 : g <= 8 ? 2 : g <= 12 ? 3 : g <= 16 ? 4 : 8;
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

// The two bf16 of a 32-bit word, as f32 (exact: a bf16 is the top half).
__device__ __forceinline__ void unpack2(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// A lane's N contiguous elements of a row in shared memory, as f32, in
// one vector load where N elements make 4, 8 or 16 bytes.
template <int N>
__device__ __forceinline__ void load_slice(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int v = 0; v < N / 4; ++v) {
      const float4 x = reinterpret_cast<const float4*>(p)[v];
      o[4 * v] = x.x;
      o[4 * v + 1] = x.y;
      o[4 * v + 2] = x.z;
      o[4 * v + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x;
    o[1] = x.y;
  } else {
    o[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void load_slice(const __nv_bfloat16* p,
                                           float (&o)[N]) {
  if constexpr (N == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    unpack2(x.x, o[0], o[1]);
    unpack2(x.y, o[2], o[3]);
    unpack2(x.z, o[4], o[5]);
    unpack2(x.w, o[6], o[7]);
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    unpack2(x.x, o[0], o[1]);
    unpack2(x.y, o[2], o[3]);
  } else if constexpr (N == 2) {
    unpack2(*reinterpret_cast<const uint32_t*>(p), o[0], o[1]);
  } else {
    o[0] = __bfloat162float(p[0]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Rows of a tile in shared memory are padded by 16 bytes, so that lanes
// reading one 16-byte chunk of 32 different rows hit every bank once per
// 8 lanes.
template <typename T, int DH>
__host__ __device__ constexpr int padded_row() {
  return DH + 16 / static_cast<int>(sizeof(T));
}

// Bytes of dynamic shared memory of the split kernel: the group's q rows
// (f32), two stages of a k and a v tile, and the tile's probabilities.
template <typename T, int DH>
constexpr size_t smem_bytes(int g) {
  return static_cast<size_t>(g) * DH * sizeof(float) +
         2 * 2 * static_cast<size_t>(kBK) * padded_row<T, DH>() * sizeof(T) +
         static_cast<size_t>(rows_of(g)) * kWarps * kBK * sizeof(float);
}

// One block: run positions [split * per, ...) of row bb's kv head kh.
// Warp w computes the rows i = w + kWarps * r, r < ROWS (ROWS =
// ceil(g / kWarps)); a row past g repeats row g - 1 and is not written,
// so every loop below is unrolled with no branch on the row.
// splits == 1: writes o; else the partial of (bb, kh, split) into
// part_acc [B, K, splits, g, DH], part_m and part_l [B, K, splits, g].
template <typename T, int DH, int ROWS>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ lengths,
                        const int* __restrict__ starts, T* __restrict__ o,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_m,
                        float* __restrict__ part_l, int g, int T_len,
                        int splits, Strides sq, Strides sk, Strides sv,
                        Strides so, float scale) {
  constexpr int N = DH / kWarp;              // a lane's slice of dh (P.V)
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // per 16 bytes
  constexpr int CH = DH / EPC;               // 16-byte chunks of a row
  constexpr int LD = padded_row<T, DH>();
  constexpr int QCH = kMaxOut / EPC / kThreads;  // q chunks a thread loads
  static_assert(CH % 4 == 0, "four partial sums over a row's chunks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);          // [g][DH]
  T* Ks = reinterpret_cast<T*>(Qs + g * DH);               // [2][kBK][LD]
  T* Vs = Ks + 2 * kBK * LD;                               // [2][kBK][LD]
  float* Ps = reinterpret_cast<float*>(Vs + 2 * kBK * LD); // [g][kBK]

  const int split = blockIdx.x, kh = blockIdx.y, bb = blockIdx.z;
  const int n_kv = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp, warp = tid / kWarp;
  const int len = max(0, min(lengths[bb], T_len));
  // The run's first slot, in [0, T): slot (start + j) mod T for j < len.
  const int start =
      starts != nullptr ? ((starts[bb] % T_len) + T_len) % T_len : 0;
  const int per = (len + splits - 1) / splits;
  const int j0 = min(len, split * per);
  const int n_rows = min(len, j0 + per) - j0;
  int row[ROWS];                 // this warp's rows, clamped to g - 1
#pragma unroll
  for (int r = 0; r < ROWS; ++r) row[r] = min(warp + kWarps * r, g - 1);

  const T* qb = q + bb * sq.b + (kh * g) * sq.h;
  const T* kb = kc + bb * sk.b + kh * sk.h;
  const T* vb = vc + bb * sv.b + kh * sv.h;

  // Issue tile `tile`'s k and v rows into stage `buf`, 16 bytes a thread.
  auto issue = [&](int tile, int buf) {
    const int nr = min(kBK, n_rows - tile * kBK);
    for (int c = tid; c < nr * CH; c += kThreads) {
      const int r = c / CH, x = c % CH;
      int slot = start + j0 + tile * kBK + r;   // < 2T: one wrap at most
      if (slot >= T_len) slot -= T_len;
      const int off = (buf * kBK + r) * LD + x * EPC;
      cp_async16(Ks + off, kb + slot * sk.s + x * EPC);
      cp_async16(Vs + off, vb + slot * sv.s + x * EPC);
    }
    cp_async_commit();
  };

  const int n_tiles = (n_rows + kBK - 1) / kBK;
  if (n_tiles > 0) {
    issue(0, 0);
    // The group's q rows as f32, 16 bytes a load, while tile 0 flies.
    float qv[QCH][EPC];
#pragma unroll
    for (int u = 0; u < QCH; ++u) {
      const int c = tid + u * kThreads;
      if (c < g * CH)
        load_slice<EPC>(qb + (c / CH) * sq.h + (c % CH) * EPC, qv[u]);
    }
#pragma unroll
    for (int u = 0; u < QCH; ++u) {
      const int c = tid + u * kThreads;
      if (c < g * CH) {
#pragma unroll
        for (int e = 0; e < EPC; ++e) Qs[c * EPC + e] = qv[u][e];
      }
    }
  }

  float acc[ROWS][N], m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[r][e] = 0.0f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      issue(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();             // this tile's rows (and q) are in
    const int nr = min(kBK, n_rows - tile * kBK);
    const T* kt = Ks + buf * kBK * LD;
    const T* vt = Vs + buf * kBK * LD;

    // Scores: lane j takes key j of the tile, for this warp's rows, in
    // four partial sums over the row's 16-byte chunks (c mod 4).
    float sp[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) sp[r][u] = 0.0f;
    const T* kj = kt + lane * LD;    // past nr: stale rows, masked below
#pragma unroll 1
    for (int c0 = 0; c0 < CH; c0 += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + u;
        float kf[EPC];
        load_slice<EPC>(kj + c * EPC, kf);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float qf[EPC];
          load_slice<EPC>(Qs + row[r] * DH + c * EPC, qf);
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            sp[r][u] = fmaf(qf[e], kf[e], sp[r][u]);
        }
      }
    }

    // Softmax of the tile, key j in lane j; rescale the outputs.
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float s = ((sp[r][0] + sp[r][1]) + (sp[r][2] + sp[r][3]))
                      * scale;
      const float sj = lane < nr ? s : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sj));
      const float p = lane < nr ? expf(sj - m_new) : 0.0f;
      Ps[(warp + kWarps * r) * kBK + lane] = p;
      const float sum = warp_sum(p);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < N; ++e) acc[r][e] = acc[r][e] * alpha;
    }
    __syncwarp();

    // P.V into each lane's slice of this warp's rows.
#pragma unroll 4
    for (int j = 0; j < nr; ++j) {
      float vr[N];
      load_slice<N>(vt + j * LD + lane * N, vr);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = Ps[(warp + kWarps * r) * kBK + j];
#pragma unroll
        for (int e = 0; e < N; ++e) acc[r][e] = fmaf(p, vr[e], acc[r][e]);
      }
    }
    __syncthreads();             // the stage is free for tile + 2
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = warp + kWarps * r;
    if (i < g) {
      if (splits == 1) {
        T* oi = o + bb * so.b + (kh * g + i) * so.h + lane * N;
        const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int e = 0; e < N; ++e) oi[e] = from_f32<T>(acc[r][e] / den);
      } else {
        const size_t row_i =
            ((static_cast<size_t>(bb) * n_kv + kh) * splits + split) * g + i;
        float* pa = part_acc + row_i * DH + lane * N;
#pragma unroll
        for (int e = 0; e < N; ++e) pa[e] = acc[r][e];
        if (lane == 0) {
          part_m[row_i] = m[r];
          part_l[row_i] = l[r];
        }
      }
    }
  }
}

// Merge the splits of one (b, h): grid (g, K, B), DH threads, one output
// element each.  The splits' m and l go to shared memory in one pass;
// every thread then forms M, the weights and L itself, in split order
// (so all get the same bits), beside its own sum of the weighted acc.
template <typename T, int DH>
__global__ void __launch_bounds__(DH)
    decode_merge_kernel(const float* __restrict__ part_acc,
                        const float* __restrict__ part_m,
                        const float* __restrict__ part_l, T* __restrict__ o,
                        int g, int splits, Strides so) {
  __shared__ float m_s[kMaxSplits], l_s[kMaxSplits];
  const int i = blockIdx.x, kh = blockIdx.y, bb = blockIdx.z;
  const int n_kv = gridDim.y;
  const int d = threadIdx.x;
  const size_t base = (static_cast<size_t>(bb) * n_kv + kh) * splits;
  for (int s = d; s < splits; s += DH) {
    m_s[s] = part_m[(base + s) * g + i];
    l_s[s] = part_l[(base + s) * g + i];
  }
  __syncthreads();
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m_s[s]);
  float big_l = 0.0f, a = 0.0f;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const float w = expf(m_s[s] - mx);
    big_l = big_l + w * l_s[s];
    a = a + w * part_acc[((base + s) * g + i) * DH + d];
  }
  o[bb * so.b + (kh * g + i) * so.h + d] =
      from_f32<T>(a / fmaxf(big_l, 1e-30f));
}

template <typename T, int DH, int ROWS>
int launch_rows(const void* q, const void* kc, const void* vc,
                const int* lengths, const int* starts, void* o, float* part,
                int B, int H, int KH, int T_len, int splits,
                const long long* st, float scale, cudaStream_t stream) {
  const int g = H / KH;
  const size_t smem = smem_bytes<T, DH>(g);
  // Allow the largest group this instantiation takes, once per device.
  static unsigned long long allowed = 0;   // bit d: device d is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(allowed >> (dev & 63) & 1)) {
    const int g_max = min(kWarps * ROWS, kMaxOut / DH);
    err = cudaFuncSetAttribute(
        decode_split_kernel<T, DH, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<T, DH>(g_max)));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed |= 1ull << (dev & 63);
  }
  const Strides sq{st[0], st[1], 0}, sk{st[2], st[3], st[4]},
      sv{st[5], st[6], st[7]}, so{st[8], st[9], 0};
  const size_t rows = static_cast<size_t>(B) * KH * splits * g;
  float* part_acc = part;
  float* part_m = splits > 1 ? part + rows * DH : nullptr;
  float* part_l = splits > 1 ? part_m + rows : nullptr;
  decode_split_kernel<T, DH, ROWS>
      <<<dim3(splits, KH, B), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(kc),
          static_cast<const T*>(vc), lengths, starts, static_cast<T*>(o),
          part_acc, part_m, part_l, g, T_len, splits, sq, sk, sv, so, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  decode_merge_kernel<T, DH>
      <<<dim3(g, KH, B), DH, 0, stream>>>(
          part_acc, part_m, part_l, static_cast<T*>(o), g, splits, so);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for the group's rows per warp (rows_of(g)); a group
// over min(32, 4096 / DH) heads is refused.
template <typename T, int DH>
int launch(const void* q, const void* kc, const void* vc, const int* lengths,
           const int* starts, void* o, float* part, int B, int H, int KH,
           int T_len, int splits, const long long* st, float scale,
           cudaStream_t stream) {
  const int g = H / KH;
  if (g > kMaxGroup || g * DH > kMaxOut || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
#define DECODE_ROWS(R)                                                     \
  case R:                                                                  \
    return launch_rows<T, DH, (R * kWarps * DH <= kMaxOut ? R : 1)>(       \
        q, kc, vc, lengths, starts, o, part, B, H, KH, T_len, splits, st, \
        scale, stream);
  switch (rows_of(g)) {
    DECODE_ROWS(1)
    DECODE_ROWS(2)
    DECODE_ROWS(3)
    DECODE_ROWS(4)
    DECODE_ROWS(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DECODE_ROWS
}

template <typename T>
int dispatch(const void* q, const void* kc, const void* vc,
             const int* lengths, const int* starts, void* o, float* part,
             int B, int H, int KH, int T_len, int dh, int splits,
             const long long* st, float scale, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, kc, vc, lengths, starts, o, part, B, H, KH,
                           T_len, splits, st, scale, stream);
    case 64:
      return launch<T, 64>(q, kc, vc, lengths, starts, o, part, B, H, KH,
                           T_len, splits, st, scale, stream);
    case 128:
      return launch<T, 128>(q, kc, vc, lengths, starts, o, part, B, H, KH,
                            T_len, splits, st, scale, stream);
    case 256:
      return launch<T, 256>(q, kc, vc, lengths, starts, o, part, B, H, KH,
                            T_len, splits, st, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// o = decode attention of q against the valid slots of each row's caches,
// on `stream`: (starts[b] + j) mod T for j < lengths[b], where starts may
// be null (zeros).  Each row's run is split over `splits` blocks; with
// more than one, `part` is the f32 scratch of B * H * splits * (dh + 2)
// floats (acc, then m, then l) and a merge kernel follows; with one it may
// be null; `splits` is at most 64.  The group's g is at most min(32,
// 4096 / dh); the wrapper checks it.  q, o: [B, H, dh]; k_cache,
// v_cache: [B, KH, T, dh], H % KH == 0; the base and outer strides of q
// and the caches multiples of 16 bytes (cp.async); lengths,
// starts: [B] int32 on the device.  f32 (bf16 = 0) or bf16 (bf16 = 1),
// all of one type.  `strides` holds 10 element strides: (batch, head) of
// q, (batch, head, row) of k_cache and v_cache, (batch, head) of o; the
// head dim is contiguous.  dh is 32, 64, 128 or 256.  Returns the
// cudaError_t of the launches (0 = success).
int decode_attention_launch(const void* q, const void* k_cache,
                            const void* v_cache, const void* lengths,
                            const void* starts, void* o, void* part,
                            int B, int H, int KH, int T_len, int dh,
                            int splits, const long long* strides,
                            float scale, int bf16, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* lens = static_cast<const int*>(lengths);
  const int* st = static_cast<const int*>(starts);
  float* pt = static_cast<float*>(part);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dispatch<__nv_bfloat16>(q, k_cache, v_cache, lens, st, o, pt, B,
                                   H, KH, T_len, dh, splits, strides, scale,
                                   s);
  }
  return dispatch<float>(q, k_cache, v_cache, lens, st, o, pt, B, H, KH,
                         T_len, dh, splits, strides, scale, s);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
