// Hand-written Hopper (sm_90a) kernels for the RG-LRU linear recurrence
// and its backward.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py::rglru_scan, which
// tiles channels into 128-lane blocks, keeps the carry in VMEM and walks
// sequence chunks along the sequential grid axis.  Per (batch b, channel r):
//
//   forward:   h_t = a_t * h_{t-1} + x_t,        h_{-1} = h0[b, r] (or 0)
//   backward:  g_t = a_{t+1} * g_{t+1} + dh_t,   g_{S-1} = dh_{S-1}
//              dx_t = g_t,  da_t = g_t * h_{t-1},  dh0 = a_0 * g_0
//
// in f32, each product and sum rounded on its own (__fmul_rn, __fadd_rn;
// the port builds every source with -fmad=false), so both equal the plain
// versions (kernels/ref.py: rglru_scan_ref, rglru_scan_bwd_ref) bit for
// bit, in f32 and in bf16: the carry h and the gradient g stay in f32 and
// are rounded to the tensors' type only where they are stored.  A chunked
// or associative scan would change the rounding, so each lane walks time
// in order (the backward in reverse).
//
// Layout: a, x, h, dh and the outputs are [B, S, R] contiguous, of one
// type (f32 or bf16), with bases that are multiples of 16 bytes; h0 and
// dh0 are [B, R] f32 contiguous, or null.  Any S >= 1 and any R.
//
// What bounds it on this card: bytes.  Each element of the inputs is read
// once and each output written once: at the training shape (B=1, S=4096,
// R=2560, f32) 126 MB for the forward (0.0376 ms at 3.35 TB/s) and 210 MB
// for the backward (a, h, dh in; da, dx out).  The serial chain is cheap
// (S x one product and one sum per lane, ~20 us at S=4096), but it keeps
// each lane's channel on one block, so the card is fed only by the
// B x R / channels blocks and by the loads each keeps in flight.
//
// What the design does:
//  - A block takes `CH` (16 or 32) neighbouring channels of one batch row,
//    so B=1, R=2560 gives 160 blocks of 16 (every SM busy); the wrapper's
//    launch plan takes 32 where that still gives a block per SM.
//  - Warps 1-3 of the block feed a ring of up to kStages stages in shared
//    memory, each `tc` (<= kTc) time steps x CH channels of every operand,
//    with 16-byte cp.async copies (the ragged end of a row copied short,
//    the rest of the 16 bytes zero-filled); kStages - 1 chunks are in
//    flight while the chain runs, tens of KB an SM instead of about one.
//    A row segment that does not start on 16 bytes (R x size not a
//    multiple of 16, e.g. bf16 at R=100) is copied from the 16 bytes
//    below it and read at its offset.
//  - The lanes of warp 0 that own a channel run the chain and nothing
//    else, from shared memory; in the forward the next kQ steps' loads
//    are issued before this kQ's chain (in the backward that measured
//    slower than the unrolled loop).  Where rows start on 16 bytes (the
//    model's widths) the outputs go to a double-buffered tile in shared
//    memory, which warps 1-3 write out with 16-byte stores while the
//    chain runs on; elsewhere the chain stores each step's CH
//    neighbouring outputs.
//    The host's launch plan (kernels/rglru_scan.py) picks CH and tc.
//  - The backward walks the chunks, and the steps in each, in reverse.  It
//    reads a as it lies and keeps a_{t+1} from the step before in a
//    register; h is staged one row early (row u of a chunk holds h_{t-1}),
//    so one launch writes dx, da and dh0 with no flipped or shifted copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // warp 0 runs the chain, warps 1-3 copy
constexpr int kCopiers = kThreads - 32;
constexpr int kStages = 4;       // ring stages in shared memory, at most
constexpr int kTc = 64;          // time steps per stage, at most
constexpr int kQ = 8;            // steps whose loads run ahead of the chain
constexpr int kMaxDevices = 64;

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

// 16-byte copy to shared memory that reads `bytes` (<= 16) of `src` and
// zero-fills the rest; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes of one staged row: CH elements and room to start 16 bytes early.
template <typename T, int CH>
__host__ __device__ constexpr int row_bytes() {
  return CH * static_cast<int>(sizeof(T)) + 16;
}
// Stages of a launch's ring: no more than it has chunks.
__host__ __device__ constexpr int stages(int S, int tc) {
  return (S + tc - 1) / tc < kStages ? (S + tc - 1) / tc : kStages;
}
// Shared memory of a launch: the ring (`ops` operands), then `tiles`
// double-buffered [tc][CH] output tiles.
template <typename T, int CH>
__host__ __device__ constexpr int smem_bytes(int ops, int tiles, int ns,
                                             int tc) {
  return ns * ops * tc * row_bytes<T, CH>() +
         2 * tiles * tc * CH * static_cast<int>(sizeof(T));
}

// The element offset of index e from the 16-byte boundary below it (bases
// are 16-aligned): where a block's lanes start in a staged row.
template <typename T>
__device__ __forceinline__ int shift(long long e) {
  return static_cast<int>((e * static_cast<long long>(sizeof(T))) & 15) /
         static_cast<int>(sizeof(T));
}

// Stage `rows` rows of one operand, times t_first.. (rows outside [0, S)
// skipped), channels r0..r0+n of batch row b (row0 = b S), into `dst`.
// Run by the copier warps.
template <typename T, int CH>
__device__ __forceinline__ void stage_rows(char* dst, const T* src,
                                           long long row0, int t_first,
                                           int rows, int S, long long R,
                                           int r0, int n) {
  constexpr int kWords = CH * static_cast<int>(sizeof(T)) / 16 + 1;
  for (int i = threadIdx.x - 32; i < rows * kWords; i += kCopiers) {
    const int u = i / kWords, w = i - u * kWords;
    const int t = t_first + u;
    if (t < 0 || t >= S) continue;
    const char* lo = reinterpret_cast<const char*>(src + (row0 + t) * R + r0);
    const char* hi = lo + n * static_cast<int>(sizeof(T));
    const char* p = reinterpret_cast<const char*>(
                        reinterpret_cast<uintptr_t>(lo) & ~uintptr_t(15)) +
                    16 * w;
    if (p >= hi) continue;
    cp_async16(dst + u * row_bytes<T, CH>() + 16 * w, p,
               static_cast<int>(hi - p < 16 ? hi - p : 16));
  }
}

// Write a staged [rows][CH] tile to rows t0.. of `dst` (16-byte aligned
// rows, n x size a multiple of 16), 16 bytes a copier thread.
template <typename T, int CH>
__device__ __forceinline__ void write_tile(T* dst, const T* tile,
                                           long long row0, int t0, int rows,
                                           long long R, int r0, int n) {
  constexpr int kW = CH * static_cast<int>(sizeof(T)) / 16;
  const int wn = n * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x - 32; i < rows * kW; i += kCopiers) {
    const int u = i / kW, w = i - u * kW;
    if (w >= wn) continue;
    *reinterpret_cast<int4*>(
        reinterpret_cast<char*>(dst + (row0 + t0 + u) * R + r0) + 16 * w) =
        *reinterpret_cast<const int4*>(
            reinterpret_cast<const char*>(tile + u * CH) + 16 * w);
  }
}

template <typename T, int CH>
__global__ void __launch_bounds__(kThreads, 2)
    rglru_fwd_kernel(const T* __restrict__ a, const T* __restrict__ x,
                     const float* __restrict__ h0, T* __restrict__ out,
                     int S, int R, int tc) {
  extern __shared__ __align__(16) char smem[];
  constexpr int kRow = row_bytes<T, CH>();
  constexpr int kRowE = kRow / static_cast<int>(sizeof(T));
  const int groups = (R + CH - 1) / CH;
  const int b = blockIdx.x / groups;
  const int r0 = (blockIdx.x - b * groups) * CH;
  const int n = min(CH, R - r0);
  const long long row0 = static_cast<long long>(b) * S;
  const int lane = threadIdx.x;              // a channel, in warp 0
  const bool copier = threadIdx.x >= 32;
  const bool chain = lane < n;
  // Rows start on 16 bytes: the chain reads them at fixed offsets and
  // stages h for the copiers' 16-byte stores.
  const bool aligned = static_cast<long long>(R) * sizeof(T) % 16 == 0;
  const int nchunk = (S + tc - 1) / tc;
  const int ns = stages(S, tc);
  const int stage = 2 * tc * kRow;
  T* tiles = reinterpret_cast<T*>(smem + ns * stage);
  float h = (chain && h0 != nullptr)
                ? h0[static_cast<long long>(b) * R + r0 + lane]
                : 0.0f;

  auto load = [&](int c) {
    char* st = smem + (c % ns) * stage;
    const int t0 = c * tc, rows = min(tc, S - t0);
    stage_rows<T, CH>(st, a, row0, t0, rows, S, R, r0, n);
    stage_rows<T, CH>(st + tc * kRow, x, row0, t0, rows, S, R, r0, n);
  };
  if (copier) {
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < nchunk) load(c);
      cp_async_commit();
    }
  }
  for (int c = 0; c < nchunk; ++c) {
    // kStages - 1 groups were committed ahead (empty past the last chunk,
    // and with ns < kStages every chunk was in them): chunk c has landed.
    if (copier) cp_async_wait<kStages - 2>();
    __syncthreads();                 // for everyone; chunk c - 1 consumed
    if (copier) {
      if (c + kStages - 1 < nchunk) load(c + kStages - 1);
      cp_async_commit();
      if (aligned && c > 0) {
        write_tile<T, CH>(out, tiles + ((c - 1) & 1) * tc * CH, row0,
                          (c - 1) * tc, tc, R, r0, n);
      }
      continue;
    }
    if (!chain) continue;
    const char* st = smem + (c % ns) * stage;
    const int t0 = c * tc, rows = min(tc, S - t0);
    if (aligned) {
      const T* ar = reinterpret_cast<const T*>(st) + lane;
      const T* xr = reinterpret_cast<const T*>(st + tc * kRow) + lane;
      T* hr = tiles + (c & 1) * tc * CH + lane;
      if (rows % kQ == 0) {
        // The next kQ steps' loads issue before this kQ's chain.
        float an[kQ], xn[kQ];
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          an[j] = to_f32(ar[j * kRowE]);
          xn[j] = to_f32(xr[j * kRowE]);
        }
#pragma unroll 1
        for (int u0 = 0; u0 < rows; u0 += kQ) {
          float av[kQ], xv[kQ];
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            av[j] = an[j];
            xv[j] = xn[j];
          }
          if (u0 + kQ < rows) {
#pragma unroll
            for (int j = 0; j < kQ; ++j) {
              an[j] = to_f32(ar[(u0 + kQ + j) * kRowE]);
              xn[j] = to_f32(xr[(u0 + kQ + j) * kRowE]);
            }
          }
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            h = __fadd_rn(__fmul_rn(av[j], h), xv[j]);
            hr[(u0 + j) * CH] = from_f32<T>(h);
          }
        }
      } else {
        for (int u = 0; u < rows; ++u) {
          h = __fadd_rn(__fmul_rn(to_f32(ar[u * kRowE]), h),
                        to_f32(xr[u * kRowE]));
          hr[u * CH] = from_f32<T>(h);
        }
      }
    } else {
#pragma unroll 4
      for (int u = 0; u < rows; ++u) {
        const long long e = (row0 + t0 + u) * R + r0;
        const int sh = shift<T>(e) + lane;
        const float av =
            to_f32(reinterpret_cast<const T*>(st + u * kRow)[sh]);
        const float xv =
            to_f32(reinterpret_cast<const T*>(st + (tc + u) * kRow)[sh]);
        h = __fadd_rn(__fmul_rn(av, h), xv);
        out[e + lane] = from_f32<T>(h);
      }
    }
  }
  __syncthreads();
  if (aligned && copier) {
    const int t0 = (nchunk - 1) * tc;
    write_tile<T, CH>(out, tiles + ((nchunk - 1) & 1) * tc * CH, row0, t0,
                      S - t0, R, r0, n);
  }
}

template <typename T, int CH>
__global__ void __launch_bounds__(kThreads, 2)
    rglru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                     const T* __restrict__ dh, const float* __restrict__ h0,
                     T* __restrict__ da, T* __restrict__ dx,
                     float* __restrict__ dh0, int S, int R, int tc) {
  extern __shared__ __align__(16) char smem[];
  constexpr int kRow = row_bytes<T, CH>();
  constexpr int kRowE = kRow / static_cast<int>(sizeof(T));
  const int groups = (R + CH - 1) / CH;
  const int b = blockIdx.x / groups;
  const int r0 = (blockIdx.x - b * groups) * CH;
  const int n = min(CH, R - r0);
  const long long row0 = static_cast<long long>(b) * S;
  const int lane = threadIdx.x;
  const bool copier = threadIdx.x >= 32;
  const bool chain = lane < n;
  const bool aligned = static_cast<long long>(R) * sizeof(T) % 16 == 0;
  const int nchunk = (S + tc - 1) / tc;
  const int ns = stages(S, tc);
  const int stage = 3 * tc * kRow;
  // [parity][dx, da][tc][CH]
  T* tiles = reinterpret_cast<T*>(smem + ns * stage);
  const float hfirst = (chain && h0 != nullptr)
                           ? h0[static_cast<long long>(b) * R + r0 + lane]
                           : 0.0f;
  float g = 0.0f, a_next = 0.0f;
  bool last = true;                 // the step t = S - 1: g = dh

  // The i-th chunk loaded and consumed is chunk nchunk - 1 - i.
  auto load = [&](int i) {
    char* st = smem + (i % ns) * stage;
    const int t0 = (nchunk - 1 - i) * tc, rows = min(tc, S - t0);
    stage_rows<T, CH>(st, a, row0, t0, rows, S, R, r0, n);
    stage_rows<T, CH>(st + tc * kRow, dh, row0, t0, rows, S, R, r0, n);
    stage_rows<T, CH>(st + 2 * tc * kRow, h, row0, t0 - 1, rows, S, R, r0,
                      n);
  };
  auto write = [&](int i) {
    const int t0 = (nchunk - 1 - i) * tc, rows = min(tc, S - t0);
    const T* tile = tiles + (i & 1) * 2 * tc * CH;
    write_tile<T, CH>(dx, tile, row0, t0, rows, R, r0, n);
    write_tile<T, CH>(da, tile + tc * CH, row0, t0, rows, R, r0, n);
  };
  if (copier) {
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < nchunk) load(i);
      cp_async_commit();
    }
  }
  for (int i = 0; i < nchunk; ++i) {
    if (copier) cp_async_wait<kStages - 2>();
    __syncthreads();
    if (copier) {
      if (i + kStages - 1 < nchunk) load(i + kStages - 1);
      cp_async_commit();
      if (aligned && i > 0) write(i - 1);
      continue;
    }
    if (!chain) continue;
    const char* st = smem + (i % ns) * stage;
    const int t0 = (nchunk - 1 - i) * tc, rows = min(tc, S - t0);
    if (aligned) {
      const T* ar = reinterpret_cast<const T*>(st) + lane;
      const T* dr = reinterpret_cast<const T*>(st + tc * kRow) + lane;
      const T* hr = reinterpret_cast<const T*>(st + 2 * tc * kRow) + lane;
      T* dxr = tiles + (i & 1) * 2 * tc * CH + lane;
      T* dar = dxr + tc * CH;
#pragma unroll 8
      for (int u = rows - 1; u >= 0; --u) {
        const float dv = to_f32(dr[u * kRowE]);
        g = last ? dv : __fadd_rn(__fmul_rn(a_next, g), dv);
        last = false;
        a_next = to_f32(ar[u * kRowE]);
        const float hp = t0 + u == 0 ? hfirst : to_f32(hr[u * kRowE]);
        dxr[u * CH] = from_f32<T>(g);
        dar[u * CH] = from_f32<T>(__fmul_rn(g, hp));
      }
    } else {
#pragma unroll 4
      for (int u = rows - 1; u >= 0; --u) {
        const int t = t0 + u;
        const long long e = (row0 + t) * R + r0;
        const int sh = shift<T>(e) + lane;
        const float av =
            to_f32(reinterpret_cast<const T*>(st + u * kRow)[sh]);
        const float dv =
            to_f32(reinterpret_cast<const T*>(st + (tc + u) * kRow)[sh]);
        g = last ? dv : __fadd_rn(__fmul_rn(a_next, g), dv);
        last = false;
        a_next = av;
        const float hp =
            t == 0 ? hfirst
                   : to_f32(reinterpret_cast<const T*>(
                         st + (2 * tc + u) * kRow)[shift<T>(e - R) + lane]);
        dx[e + lane] = from_f32<T>(g);
        da[e + lane] = from_f32<T>(__fmul_rn(g, hp));
      }
    }
  }
  __syncthreads();
  if (aligned && copier) write(nchunk - 1);
  if (chain && !copier && dh0 != nullptr) {
    dh0[static_cast<long long>(b) * R + r0 + lane] = __fmul_rn(a_next, g);
  }
}

// Raise a kernel's dynamic shared-memory limit to `most` once per device,
// and only where a launch needs more than the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, int device, int bytes, int most,
                       bool* done) {
  if (bytes <= 48 * 1024 || (device < kMaxDevices && done[device])) {
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return err;
}

template <typename T, int CH>
int launch_fwd(const void* a, const void* x, const float* h0, void* out,
               int B, int S, int R, int tc, int device, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const int smem = smem_bytes<T, CH>(2, 1, stages(S, tc), tc);
  cudaError_t err = allow_smem(rglru_fwd_kernel<T, CH>, device, smem,
                               smem_bytes<T, CH>(2, 1, kStages, kTc), done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(B) * ((R + CH - 1) / CH);
  rglru_fwd_kernel<T, CH><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), h0,
      static_cast<T*>(out), S, R, tc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CH>
int launch_bwd(const void* a, const void* h, const void* dh, const float* h0,
               void* da, void* dx, float* dh0, int B, int S, int R, int tc,
               int device, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const int smem = smem_bytes<T, CH>(3, 2, stages(S, tc), tc);
  cudaError_t err = allow_smem(rglru_bwd_kernel<T, CH>, device, smem,
                               smem_bytes<T, CH>(3, 2, kStages, kTc), done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(B) * ((R + CH - 1) / CH);
  rglru_bwd_kernel<T, CH><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(dh), h0, static_cast<T*>(da),
      static_cast<T*>(dx), dh0, S, R, tc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[b, t, r] = h_t of the recurrence h_t = a_t * h_{t-1} + x_t per
// (b, r), on `stream`.  a, x, out: [B, S, R] contiguous, 16-byte aligned,
// f32 (bf16 = 0) or bf16 (bf16 = 1), all of one type; h0: [B, R] f32
// contiguous, or null for zeros.  B, S, R >= 1; `channels` (16 or 32) a
// block, `steps` (1..64, at most S) a ring stage.  Returns the
// cudaError_t of the launch (0 = success).
int rglru_scan_launch(const void* a, const void* x, const void* h0,
                      void* out, int B, int S, int R, int bf16, int channels,
                      int steps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* c = static_cast<const float*>(h0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((channels != 16 && channels != 32) || steps < 1 || steps > kTc ||
      steps > S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bf16) {
    return channels == 16
               ? launch_fwd<__nv_bfloat16, 16>(a, x, c, out, B, S, R, steps,
                                               device, s)
               : launch_fwd<__nv_bfloat16, 32>(a, x, c, out, B, S, R, steps,
                                               device, s);
  }
  return channels == 16
             ? launch_fwd<float, 16>(a, x, c, out, B, S, R, steps, device, s)
             : launch_fwd<float, 32>(a, x, c, out, B, S, R, steps, device,
                                     s);
}

// The backward of rglru_scan_launch in one launch, on `stream`: from a, h
// (the forward's output) and dh, all [B, S, R] as there, and h0 ([B, R]
// f32 or null), writes da and dx ([B, S, R], the same type) and, when h0
// is given, dh0 ([B, R] f32).  Returns the cudaError_t of the launch.
int rglru_scan_bwd_launch(const void* a, const void* h, const void* dh,
                          const void* h0, void* da, void* dx, void* dh0,
                          int B, int S, int R, int bf16, int channels,
                          int steps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* c = static_cast<const float*>(h0);
  float* dc = static_cast<float*>(dh0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((channels != 16 && channels != 32) || steps < 1 || steps > kTc ||
      steps > S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bf16) {
    return channels == 16
               ? launch_bwd<__nv_bfloat16, 16>(a, h, dh, c, da, dx, dc, B, S,
                                               R, steps, device, s)
               : launch_bwd<__nv_bfloat16, 32>(a, h, dh, c, da, dx, dc, B, S,
                                               R, steps, device, s);
  }
  return channels == 16
             ? launch_bwd<float, 16>(a, h, dh, c, da, dx, dc, B, S, R, steps,
                                     device, s)
             : launch_bwd<float, 32>(a, h, dh, c, da, dx, dc, B, S, R, steps,
                                     device, s);
}

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
