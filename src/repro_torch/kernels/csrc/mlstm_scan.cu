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
// What bounds it on this card: operations.  A step of a head does
// 6 dh^2 f32 operations on its C (the update 4, the readout 2), and the
// steps are a dependent chain.  At the serving prefill (B=8, H=4, S=256,
// dh=192) that is 1.8 GFLOP, 0.027 ms at the 67 TFLOP/s f32 rate (half
// that rate without FMA, which the reference's rounding forbids); the
// bytes (q, k, v, h, the gates) take less.  So the card must be filled
// with heads' rows, not with heads: B x H = 32 heads are 32 of 132 SMs.
//
// What the design does:
//  - The rows of C are independent given a step's scalars (m, i', f') and
//    den = |n . q|.  So each head's rows are split over dh / 32 blocks of
//    32 rows (192 blocks at the serving shapes); every block computes the
//    scalars and all of n itself, with the same instructions on the same
//    values, so all blocks of a head get the same bits.
//  - C lives in registers: 4 warps, 8 rows a warp, 4 lanes a row, each
//    lane holding dh / 4 columns of its row (48 at dh = 192), the columns
//    16 c + 4 g + e (c < dh / 16, e < 4) of lane g, read as 16-byte (f32)
//    or 8-byte (bf16) vectors of k and q from shared memory.  No element
//    of C passes through shared memory in the step loop.
//  - n is held by every warp, 1 / 32 of it a lane (n_j for j = lane +
//    32 i), so each warp forms n . q with its own shuffles: no block-wide
//    reduction and no barrier in the step loop.
//  - k, q (whole rows), the block's slice of v and the two gates are
//    staged by cp.async in a double-buffered ring of kTc = 16 steps; the
//    block synchronises once per chunk.  Within a chunk the gates' scalars
//    come from lane t of each warp (softplus and exp in parallel, the
//    max chain over m by shuffles).  Each warp stages its rows' h for the
//    chunk in shared memory and writes them with 16-byte stores.
//  - Decode (S = 1 from a carry): each block loads only its rows of C,
//    24.6 KB at dh = 192, with 16-byte loads.
//  - q, k, v and h are read and written through strides (the head dim
//    contiguous; bases and outer strides multiples of 16 bytes), so the
//    model's [B, S, H, dh] tensors need no copy; the gates likewise.
//
// Numerics: f32 throughout; every product and sum rounded on its own
// (__fmul_rn / __fadd_rn; the build's -fmad=false besides), the update in
// the reference's order f' * C + i' * (v * k).  Two sums take another
// order than the reference's, stated here and written out in plain
// PyTorch as kernels/ref.py::mlstm_scan_rows_ref:
//  - (C q)_i: lane g keeps four partial sums p_e, each over its columns
//    16 c + 4 g + e in the order of c; it adds them as (p0 + p1) +
//    (p2 + p3), then lanes g = 0..3 combine as (s0 + s1) + (s2 + s3)
//    (shuffles xor 1, then 2).
//  - n . q: lane l sums n_j q_j over j = l, l + 32, ..., then the 32
//    lanes combine in adjacent pairs (shuffles xor 1, 2, 4, 8, 16).
// q, k, v are f32 or bf16 (h is written in their type); gates and the
// carry are f32.  No atomics: two calls on the same inputs are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kRows = 32;       // rows of C a block owns
constexpr int kGroups = 4;      // lanes a row (column groups)
constexpr int kTc = 16;         // steps a ring stage, at most
constexpr int kStages = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// Element strides (batch, head, step) of the [B, H, S, dh] views of q, k,
// v and h, and of the [B, H, S] gates.
struct Strides {
  long long q[3], k[3], v[3], h[3], i[3], f[3];
};

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

// Four consecutive elements from shared memory (16 or 8 bytes, aligned).
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  out[0] = __low2float(lo);
  out[1] = __high2float(lo);
  out[2] = __low2float(hi);
  out[3] = __high2float(hi);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// jax.nn.softplus(x) == logaddexp(x, 0) == max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// A ring stage of tc steps: k and q rows [tc][DH], the block's v slice
// [tc][kRows] (all in T), then the input and forget gates [tc] f32 each.
template <typename T, int DH>
__host__ __device__ constexpr int gates_offset(int tc) {
  return tc * (2 * DH + kRows) * static_cast<int>(sizeof(T));
}
template <typename T, int DH>
__host__ __device__ constexpr int stage_bytes(int tc) {
  return gates_offset<T, DH>(tc) + (2 * tc * 4 + 15) / 16 * 16;
}
// The ring, then each warp's h for its 8 rows over a chunk [tc][8] T.
template <typename T, int DH>
__host__ __device__ constexpr int smem_bytes(int tc) {
  return kStages * stage_bytes<T, DH>(tc) +
         (kThreads / 32) * tc * 8 * static_cast<int>(sizeof(T));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
    mlstm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ ig,
                      const float* __restrict__ fg,
                      const float* __restrict__ c0,
                      const float* __restrict__ n0,
                      const float* __restrict__ m0, T* __restrict__ h,
                      float* __restrict__ cT, float* __restrict__ nT,
                      float* __restrict__ mT, int H, int S, int tc,
                      Strides st) {
  static_assert(DH % 32 == 0 && DH >= kRows, "head dim");
  constexpr int G = kGroups;
  constexpr int kBlocks = DH / kRows;       // blocks a head
  constexpr int kC4 = DH / (4 * G);         // 4-column chunks a lane
  constexpr int kN = DH / 32;               // n entries a lane
  constexpr int kES = static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) char smem[];

  const int bh = blockIdx.x / kBlocks;
  const int rb = blockIdx.x - bh * kBlocks;
  const int b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane % G;
  const int row = warp * 8 + lane / G;            // within the block
  const int stage = stage_bytes<T, DH>(tc);
  const int goff = gates_offset<T, DH>(tc);
  T* hb = reinterpret_cast<T*>(smem + kStages * stage) + warp * tc * 8;

  const T* qb = q + b * st.q[0] + hh * st.q[1];
  const T* kb = k + b * st.k[0] + hh * st.k[1];
  const T* vb = v + b * st.v[0] + hh * st.v[1] + rb * kRows;
  const float* ib = ig + b * st.i[0] + hh * st.i[1];
  const float* fb = fg + b * st.f[0] + hh * st.f[1];
  T* hout = h + b * st.h[0] + hh * st.h[1] + rb * kRows + warp * 8;

  // The carry (this lane's columns of its row; n and m whole), or zeros
  // and m = -1e30.
  float C[4 * kC4];
  const size_t mat = (static_cast<size_t>(bh) * DH + rb * kRows + row) * DH;
#pragma unroll
  for (int c = 0; c < kC4; ++c) {
    if (c0 != nullptr) {
      load4(c0 + mat + 4 * G * c + 4 * g, C + 4 * c);
    } else {
      C[4 * c] = C[4 * c + 1] = C[4 * c + 2] = C[4 * c + 3] = 0.0f;
    }
  }
  float nn[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    nn[j] = n0 != nullptr ? n0[static_cast<size_t>(bh) * DH + lane + 32 * j]
                          : 0.0f;
  }
  float m = m0 != nullptr ? m0[bh] : -1e30f;

  const int nchunk = (S + tc - 1) / tc;
  auto load = [&](int c) {
    char* sb = smem + (c % kStages) * stage;
    const int t0 = c * tc, rows = min(tc, S - t0);
    constexpr int kW = DH * kES / 16;           // 16-byte words of a row
    for (int i = tid; i < 2 * rows * kW; i += kThreads) {
      const int which = i / (rows * kW), r = i - which * rows * kW;
      const int u = r / kW, w = r - u * kW;
      const T* src = which == 0 ? kb + (t0 + u) * st.k[2]
                                : qb + (t0 + u) * st.q[2];
      cp_async16(sb + (which * tc + u) * DH * kES + 16 * w,
                 reinterpret_cast<const char*>(src) + 16 * w);
    }
    constexpr int kV = kRows * kES / 16;
    for (int i = tid; i < rows * kV; i += kThreads) {
      const int u = i / kV, w = i - u * kV;
      cp_async16(sb + 2 * tc * DH * kES + u * kRows * kES + 16 * w,
                 reinterpret_cast<const char*>(vb + (t0 + u) * st.v[2]) +
                     16 * w);
    }
    if (tid < rows) {
      cp_async4(sb + goff + 4 * tid, ib + (t0 + tid) * st.i[2]);
    } else if (tid >= 64 && tid - 64 < rows) {
      cp_async4(sb + goff + 4 * (tc + tid - 64),
                fb + (t0 + tid - 64) * st.f[2]);
    }
  };

  load(0);
  cp_async_commit();
  for (int c = 0; c < nchunk; ++c) {
    cp_async_wait_all();
    __syncthreads();                // chunk c landed; chunk c - 1 consumed
    if (c + 1 < nchunk) load(c + 1);
    cp_async_commit();
    const char* sb = smem + (c % kStages) * stage;
    const T* kc = reinterpret_cast<const T*>(sb);
    const T* qc = kc + tc * DH;
    const T* vc = qc + tc * DH;
    const float* igc = reinterpret_cast<const float*>(sb + goff);
    const float* fgc = igc + tc;
    const int t0 = c * tc, rows = min(tc, S - t0);

    // The chunk's scalars: lane u holds step u's.  Every lane runs the
    // max chain over m, so every thread ends with the same m.
    float lf = 0.0f, it = 0.0f;
    if (lane < rows) {
      it = igc[lane];
      lf = -softplus(-fgc[lane]);
    }
    float m_prev = 0.0f, m_cur = 0.0f;
    for (int u = 0; u < rows; ++u) {
      const float mn = fmaxf(__fadd_rn(__shfl_sync(kFull, lf, u), m),
                             __shfl_sync(kFull, it, u));
      if (lane == u) {
        m_prev = m;
        m_cur = mn;
      }
      m = mn;
    }
    const float ip_l = expf(__fsub_rn(it, m_cur));
    const float fp_l = expf(__fsub_rn(__fadd_rn(lf, m_prev), m_cur));

    // Two steps at once: the tail of one (its sums, the division) runs
    // beside the next one's update.
#pragma unroll 2
    for (int u = 0; u < rows; ++u) {
      const float fp = __shfl_sync(kFull, fp_l, u);
      const float ip = __shfl_sync(kFull, ip_l, u);
      const T* kr = kc + u * DH;
      const T* qr = qc + u * DH;
      // n and n . q, whole in every warp.
      float p = 0.0f;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float kj = to_f32(kr[lane + 32 * j]);
        const float qj = to_f32(qr[lane + 32 * j]);
        nn[j] = __fadd_rn(__fmul_rn(fp, nn[j]), __fmul_rn(ip, kj));
        const float pj = __fmul_rn(nn[j], qj);
        p = j == 0 ? pj : __fadd_rn(p, pj);
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        p = __fadd_rn(p, __shfl_xor_sync(kFull, p, off));
      }
      // This lane's columns of its row: the update, then (C q)_i as four
      // partial sums, one per element e of the 4-column chunks.
      const float vi = to_f32(vc[u * kRows + row]);
      float part[4];
#pragma unroll
      for (int c4 = 0; c4 < kC4; ++c4) {
        float kk[4], qq[4];
        load4(kr + 4 * G * c4 + 4 * g, kk);
        load4(qr + 4 * G * c4 + 4 * g, qq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& cij = C[4 * c4 + e];
          cij = __fadd_rn(__fmul_rn(fp, cij),
                          __fmul_rn(ip, __fmul_rn(vi, kk[e])));
          const float pe = __fmul_rn(cij, qq[e]);
          part[e] = c4 == 0 ? pe : __fadd_rn(part[e], pe);
        }
      }
      float num = __fadd_rn(__fadd_rn(part[0], part[1]),
                            __fadd_rn(part[2], part[3]));
#pragma unroll
      for (int off = 1; off < G; off <<= 1) {
        num = __fadd_rn(num, __shfl_xor_sync(kFull, num, off));
      }
      if (g == 0) {
        hb[u * 8 + row - warp * 8] =
            from_f32<T>(__fdiv_rn(num, fmaxf(fabsf(p), 1.0f)));
      }
    }
    // The warp's 8 rows of h for the chunk, 16 bytes a lane.
    __syncwarp();
    constexpr int kPieces = 8 * kES / 16;
    if (lane < rows * kPieces) {
      const int u = lane / kPieces, w = lane - u * kPieces;
      *reinterpret_cast<int4*>(
          reinterpret_cast<char*>(hout + (t0 + u) * st.h[2]) + 16 * w) =
          *reinterpret_cast<const int4*>(
              reinterpret_cast<const char*>(hb + u * 8) + 16 * w);
    }
    __syncwarp();
  }

  float* ct = cT + mat;
#pragma unroll
  for (int c = 0; c < kC4; ++c) {
    *reinterpret_cast<float4*>(ct + 4 * G * c + 4 * g) =
        make_float4(C[4 * c], C[4 * c + 1], C[4 * c + 2], C[4 * c + 3]);
  }
  if (rb == 0 && warp == 0) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      nT[static_cast<size_t>(bh) * DH + lane + 32 * j] = nn[j];
    }
    if (lane == 0) mT[bh] = m;
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, const void* c0, const void* n0, const void* m0,
           void* h, void* cT, void* nT, void* mT, int B, int H, int S,
           const Strides& st, int device, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const int tc = S < kTc ? S : kTc;
  const int smem = smem_bytes<T, DH>(tc);
  if (smem > 48 * 1024 && !(device < kMaxDevices && done[device])) {
    cudaError_t err = cudaFuncSetAttribute(
        mlstm_scan_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T, DH>(kTc));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) done[device] = true;
  }
  const unsigned blocks = static_cast<unsigned>(B) * H * (DH / kRows);
  mlstm_scan_kernel<T, DH><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<const float*>(m0),
      static_cast<T*>(h), static_cast<float*>(cT), static_cast<float*>(nT),
      static_cast<float*>(mT), H, S, tc, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v,
             const void* ig, const void* fg, const void* c0, const void* n0,
             const void* m0, void* h, void* cT, void* nT, void* mT, int B,
             int H, int S, const Strides& st, int device,
             cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, ig, fg, c0, n0, m0, h, cT, nT, mT, B,
                              H, S, st, device, stream);
    case 64:
      return launch<T, 64>(q, k, v, ig, fg, c0, n0, m0, h, cT, nT, mT, B,
                              H, S, st, device, stream);
    case 128:
      return launch<T, 128>(q, k, v, ig, fg, c0, n0, m0, h, cT, nT, mT,
                               B, H, S, st, device, stream);
    case 192:
      return launch<T, 192>(q, k, v, ig, fg, c0, n0, m0, h, cT, nT, mT,
                               B, H, S, st, device, stream);
    case 256:
      return launch<T, 256>(q, k, v, ig, fg, c0, n0, m0, h, cT, nT, mT,
                               B, H, S, st, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Scan B x H independent heads of S steps on `stream`.  q, k, v, h:
// [B, H, S, dh] views in f32 (bf16 = 0) or bf16 (bf16 = 1), the head dim
// contiguous, with the element strides (batch, head, step) in
// strides[0..2] (q), [3..5] (k), [6..8] (v), [9..11] (h); bases and
// strides multiples of 16 bytes.  ig, fg: [B, H, S] f32 views, strides in
// [12..14] and [15..17].  c0/cT: [B, H, dh, dh], n0/nT: [B, H, dh],
// m0/mT: [B, H], f32 contiguous, 16-byte aligned; c0, n0, m0 all null (no
// carry) or all set.  dh in {32, 64, 128, 192, 256}.  Returns the
// cudaError_t of the launch (0 = success).
int mlstm_scan_launch(const void* q, const void* k, const void* v,
                      const void* ig, const void* fg, const void* c0,
                      const void* n0, const void* m0, void* h, void* cT,
                      void* nT, void* mT, int B, int H, int S, int dh,
                      const long long* strides, int bf16, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.h[i] = strides[9 + i];
    st.i[i] = strides[12 + i];
    st.f[i] = strides[15 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dispatch<__nv_bfloat16>(dh, q, k, v, ig, fg, c0, n0, m0, h, cT,
                                   nT, mT, B, H, S, st, device, s);
  }
  return dispatch<float>(dh, q, k, v, ig, fg, c0, n0, m0, h, cT, nT, mT, B,
                         H, S, st, device, s);
}

const char* mlstm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
