// Hand-written Hopper (sm_90a) kernel for the lock simulator's event loop.
//
// Replaces the TPU kernel repro/kernels/simstep.py::fused_chunk, which
// retires `chunk` events of the engine's masked step inside one
// pallas_call with the packed state held in VMEM.  This kernel does the
// same work for a batch of sweep cells: each launch advances every cell by
// up to `chunk` events of the closed-loop step (acquire, release, standby
// expiry) under the fifo / tas / prop / libasl hooks, chosen by the policy
// id.  Results are bit-identical to the plain PyTorch step
// (repro_torch/core/simlock.py::_step) and to the JAX package.
//
// What bounds it on this card: each cell is one serial chain of events.
// An event reads the head of the event clock (N ints), then the handler
// makes a short chain of dependent loads and stores on the cell's state
// (the core's phase, segment, lock, queue head/tail, holder, one ring
// sample), about 100-200 bytes per event.  The bytes are tiny against
// 3.35 TB/s; what limits a cell is the latency of that dependent chain,
// and the card is filled only by running many cells at once.
//
// What the design does about it: one warp per cell, lane = core.  The
// argmin of t_ready is a warp shuffle reduction on (t_ready, lane) that
// breaks ties to the lowest core, as jnp.argmin does; lane 0 then runs the
// one handler the head core's phase selects, and __syncwarp orders its
// stores before the next event's loads.  Cells run in parallel, four warps
// to a block.  A warp stops as soon as its cell is past its horizon or
// event cap, so finished cells cost nothing.  State stays in device memory
// in the port's cell-major layout (staging it in registers and shared
// memory is the next step).
//
// Bit-exactness: build with -fmad=false (no a*b+c contraction), keep the
// reference's compiled f32 operation order (its AIMD unit is one multiply
// by a folded constant), truncate f32->i32 toward zero, take the
// weighted-pick prefix sum left to right in lane 0, and split the RNG key
// on every release of tas / libasl (even when no standby pick follows).

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kNonCrit = 0, kStandby = 1, kQueued = 2, kHolder = 3,
              kSpin = 4;
constexpr int kInf = 1 << 30;
constexpr int kFifo = 0, kTas = 1, kProp = 2, kLibasl = 3;
constexpr int kMaxCores = 32;
constexpr int kWarpsPerBlock = 4;

struct Args {
  // tables
  const int* big;
  const int* cs_dur;
  const int* nc_dur;
  const int* inter;
  const int* seg_lock;
  const float* slo_scale;
  // params
  const float* slo;
  const float* w_big;
  const int* prop_n;
  const int* horizon;
  // state
  int* t;
  long long* key;
  int* phase;
  int* t_ready;
  int* seg;
  int* epoch_start;
  int* attempt_t;
  float* window;
  float* unit;
  int* q;
  int* q_head;
  int* q_tail;
  int* holder;
  int* prop_ctr;
  float* ep_lat;
  int* ep_cnt;
  float* cs_lat;
  int* cs_cnt;
  int* events;
  // shapes and config
  int n_cells, n, s, l, cap, policy, chunk, max_events;
  float unit_mul, max_window;
};

// One cell's slice of every array, plus the shared config.
struct Cell {
  const int* big;
  const int* cs_dur;
  const int* nc_dur;
  const int* inter;
  const int* seg_lock;
  const float* slo_scale;
  float slo, w_big;
  int prop_n, horizon;
  int* t;
  long long* key;
  int* phase;
  int* t_ready;
  int* seg;
  int* epoch_start;
  int* attempt_t;
  float* window;
  float* unit;
  int* q;
  int* q_head;
  int* q_tail;
  int* holder;
  int* prop_ctr;
  float* ep_lat;
  int* ep_cnt;
  float* cs_lat;
  int* cs_cnt;
  int* events;
  int n, s, cap, policy, max_events;
  float unit_mul, max_window;
};

__device__ Cell cell_of(const Args& a, int b) {
  const size_t n = a.n, s = a.s, l = a.l, cap = a.cap, cb = b;
  Cell c;
  c.big = a.big + cb * n;
  c.cs_dur = a.cs_dur + cb * n * s;
  c.nc_dur = a.nc_dur + cb * n * s;
  c.inter = a.inter + cb * n;
  c.seg_lock = a.seg_lock + cb * s;
  c.slo_scale = a.slo_scale + cb * n;
  c.slo = a.slo[b];
  c.w_big = a.w_big[b];
  c.prop_n = a.prop_n[b];
  c.horizon = a.horizon[b];
  c.t = a.t + cb;
  c.key = a.key + 2 * cb;
  c.phase = a.phase + cb * n;
  c.t_ready = a.t_ready + cb * n;
  c.seg = a.seg + cb * n;
  c.epoch_start = a.epoch_start + cb * n;
  c.attempt_t = a.attempt_t + cb * n;
  c.window = a.window + cb * n;
  c.unit = a.unit + cb * n;
  c.q = a.q + cb * l * 2 * n;
  c.q_head = a.q_head + cb * l * 2;
  c.q_tail = a.q_tail + cb * l * 2;
  c.holder = a.holder + cb * l;
  c.prop_ctr = a.prop_ctr + cb * l;
  c.ep_lat = a.ep_lat + cb * n * cap;
  c.ep_cnt = a.ep_cnt + cb * n;
  c.cs_lat = a.cs_lat + cb * n * cap;
  c.cs_cnt = a.cs_cnt + cb * n;
  c.events = a.events + cb;
  c.n = a.n;
  c.s = a.s;
  c.cap = a.cap;
  c.policy = a.policy;
  c.max_events = a.max_events;
  c.unit_mul = a.unit_mul;
  c.max_window = a.max_window;
  return c;
}

// ---------------------------------------------------------------- RNG ----
// threefry2x32, 20 rounds: jax.random's default block.

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// jax.random.split(key): keep subkey 0 as the cell's key, return subkey 1.
__device__ void advance_key(Cell& c, uint32_t& s0, uint32_t& s1) {
  const uint32_t k0 = static_cast<uint32_t>(c.key[0]);
  const uint32_t k1 = static_cast<uint32_t>(c.key[1]);
  uint32_t n0 = 0, n1 = 0;
  threefry2x32(k0, k1, n0, n1);
  s0 = 0;
  s1 = 1;
  threefry2x32(k0, k1, s0, s1);
  c.key[0] = static_cast<long long>(n0);
  c.key[1] = static_cast<long long>(n1);
}

// jax.random.uniform(key): 23 random mantissa bits under exponent 0.
__device__ float uniform01(uint32_t k0, uint32_t k1) {
  uint32_t y0 = 0, y1 = 0;
  threefry2x32(k0, k1, y0, y1);
  const uint32_t bits = ((y0 ^ y1) >> 9) | 0x3F800000u;
  return fmaxf(0.0f, __fsub_rn(__uint_as_float(bits), 1.0f));
}

// First index whose left-to-right f32 prefix sum exceeds u * total (0 when
// none does); `any` is total > 0.
__device__ int weighted_pick(uint32_t s0, uint32_t s1, const float* w, int n,
                             bool& any) {
  float cum[kMaxCores];
  float acc = w[0];
  cum[0] = acc;
  for (int j = 1; j < n; ++j) {
    acc = __fadd_rn(acc, w[j]);
    cum[j] = acc;
  }
  const float u = __fmul_rn(uniform01(s0, s1), acc);
  any = acc > 0.0f;
  for (int j = 0; j < n; ++j) {
    if (cum[j] > u) return j;
  }
  return 0;
}

// ------------------------------------------------------------ helpers ----

__device__ __forceinline__ int qlen(const Cell& c, int l, int b) {
  return c.q_tail[l * 2 + b] - c.q_head[l * 2 + b];
}

__device__ void enq(Cell& c, int l, int b, int core) {
  const int i = l * 2 + b;
  const int tail = c.q_tail[i];
  c.q[i * c.n + tail % c.n] = core;
  c.q_tail[i] = tail + 1;
}

__device__ int deq(Cell& c, int l, int b) {
  const int i = l * 2 + b;
  const int head = c.q_head[i];
  if (c.q_tail[i] <= head) return -1;
  c.q_head[i] = head + 1;
  return c.q[i * c.n + head % c.n];
}

__device__ __forceinline__ int lock_of(const Cell& c, int core) {
  return c.seg_lock[c.seg[core]];
}

// Make `core` the holder of its segment's lock; schedule its release.
__device__ void grant(Cell& c, int core, int t) {
  const int s = c.seg[core];
  c.holder[c.seg_lock[s]] = core;
  c.phase[core] = kHolder;
  c.t_ready[core] = t + c.cs_dur[core * c.s + s];
}

__device__ __forceinline__ void park(Cell& c, int core, int ph) {
  c.phase[core] = ph;
  c.t_ready[core] = kInf;
}

__device__ __forceinline__ void record(float* buf, int* cnt, int core,
                                       int cap, float v) {
  const int k = cnt[core];
  buf[static_cast<size_t>(core) * cap + k % cap] = v;
  cnt[core] = k + 1;
}

// ------------------------------------------------------------ handlers ---

__device__ void acquire(Cell& c, int core, int t) {
  c.attempt_t[core] = t;
  const int l = lock_of(c, core);
  const bool free = c.holder[l] == -1;
  switch (c.policy) {
    case kFifo:
      if (free && qlen(c, l, 0) == 0) {
        grant(c, core, t);
      } else {
        enq(c, l, 0, core);
        park(c, core, kQueued);
      }
      break;
    case kTas:
      if (free) {
        grant(c, core, t);
      } else {
        park(c, core, kSpin);
      }
      break;
    case kProp:
      if (free && qlen(c, l, 0) == 0 && qlen(c, l, 1) == 0) {
        grant(c, core, t);
      } else {
        enq(c, l, c.big[core] == 1 ? 0 : 1, core);
        park(c, core, kQueued);
      }
      break;
    case kLibasl:
      if (free && qlen(c, l, 0) == 0) {
        grant(c, core, t);
      } else if (c.big[core] == 1) {
        enq(c, l, 0, core);
        park(c, core, kQueued);
      } else {
        // Little core: stand by for the (capped) reorder window.
        const int win = static_cast<int>(fminf(c.window[core], c.max_window));
        c.phase[core] = kStandby;
        c.t_ready[core] = t + max(win, 0);
      }
      break;
  }
}

__device__ void standby_expiry(Cell& c, int core, int t) {
  const int l = lock_of(c, core);
  if (c.holder[l] == -1 && qlen(c, l, 0) == 0) {
    grant(c, core, t);
  } else {
    enq(c, l, 0, core);
    park(c, core, kQueued);
  }
}

// Algorithm 2 (libasl, little cores, at an epoch end).
__device__ void aimd(Cell& c, int core, float latency) {
  float w = c.window[core];
  float u = c.unit[core];
  if (latency > __fmul_rn(c.slo, c.slo_scale[core])) {
    w = __fmul_rn(w, 0.5f);
    u = __fmul_rn(w, c.unit_mul);  // unit_factor(pct), see aimd.py
  }
  c.window[core] = fminf(fmaxf(__fadd_rn(w, u), 0.0f), c.max_window);
  c.unit[core] = u;
}

__device__ void pick_next(Cell& c, int l, int t) {
  float w[kMaxCores];
  uint32_t s0, s1;
  bool any;
  switch (c.policy) {
    case kFifo:
      if (qlen(c, l, 0) > 0) grant(c, deq(c, l, 0), t);
      break;
    case kTas: {
      for (int j = 0; j < c.n; ++j) {
        w[j] = (c.phase[j] == kSpin && lock_of(c, j) == l)
                   ? (c.big[j] == 1 ? c.w_big : 1.0f)
                   : 0.0f;
      }
      advance_key(c, s0, s1);
      const int winner = weighted_pick(s0, s1, w, c.n, any);
      if (any) grant(c, winner, t);
      break;
    }
    case kProp: {
      const int nb = qlen(c, l, 0), nl = qlen(c, l, 1);
      if (nb > 0 && (c.prop_ctr[l] < c.prop_n || nl == 0)) {
        c.prop_ctr[l] += 1;
        grant(c, deq(c, l, 0), t);
      } else if (nl > 0) {
        c.prop_ctr[l] = 0;
        grant(c, deq(c, l, 1), t);
      }
      break;
    }
    case kLibasl: {
      const bool nonempty = qlen(c, l, 0) > 0;
      if (nonempty) grant(c, deq(c, l, 0), t);
      // Queue empty -> a standby core may grab the free lock.
      for (int j = 0; j < c.n; ++j) {
        w[j] = (c.phase[j] == kStandby && lock_of(c, j) == l) ? 1.0f : 0.0f;
      }
      advance_key(c, s0, s1);
      const int pick = weighted_pick(s0, s1, w, c.n, any);
      if (!nonempty && any) grant(c, pick, t);
      break;
    }
  }
}

__device__ void release(Cell& c, int core, int t) {
  const int s = c.seg[core];
  const int l = c.seg_lock[s];
  record(c.cs_lat, c.cs_cnt, core, c.cap,
         static_cast<float>(t - c.attempt_t[core]));
  const bool last = s == c.s - 1;
  const float ep_latency = static_cast<float>(t - c.epoch_start[core]);
  if (last) record(c.ep_lat, c.ep_cnt, core, c.cap, ep_latency);
  if (c.policy == kLibasl && last && c.big[core] == 0) {
    aimd(c, core, ep_latency);
  }
  const int inter = c.inter[core];
  if (last) {
    c.seg[core] = 0;
    c.epoch_start[core] = t + inter;
    c.t_ready[core] = t + inter + c.nc_dur[core * c.s];
  } else {
    c.seg[core] = s + 1;
    c.t_ready[core] = t + c.nc_dur[core * c.s + min(s + 1, c.s - 1)];
  }
  c.phase[core] = kNonCrit;
  c.holder[l] = -1;
  pick_next(c, l, t);
}

// One event of one cell (the caller checked that the cell is live).
__device__ void step(Cell& c, int core, int t) {
  *c.t = t;
  *c.events += 1;
  const int ph = c.phase[core];
  if (ph == kNonCrit) {
    acquire(c, core, t);
  } else if (ph == kHolder) {
    release(c, core, t);
  } else if (ph == kStandby) {
    if (c.policy == kLibasl) standby_expiry(c, core, t);
  } else if (ph == kQueued || ph == kSpin) {
    c.t_ready[core] = kInf;  // defensive re-park
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    fused_chunk_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= a.n_cells) return;  // uniform across the warp
  Cell c = cell_of(a, b);
  for (int it = 0; it < a.chunk; ++it) {
    // Head of the event clock: min t_ready, lowest core on ties.
    int tr = lane < c.n ? c.t_ready[lane] : INT_MAX;
    int idx = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int o_tr = __shfl_down_sync(0xffffffffu, tr, off);
      const int o_idx = __shfl_down_sync(0xffffffffu, idx, off);
      if (o_tr < tr || (o_tr == tr && o_idx < idx)) {
        tr = o_tr;
        idx = o_idx;
      }
    }
    const int t = __shfl_sync(0xffffffffu, tr, 0);
    const int core = __shfl_sync(0xffffffffu, idx, 0);
    if (!(t < c.horizon && *c.events < c.max_events)) break;
    if (lane == 0) step(c, core, t);
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Advance every cell by up to `chunk` events on `stream`.  Returns the
// cudaError_t of the launch (0 = success); the caller raises on anything
// else.  Pointers are device pointers into contiguous cell-major tensors.
int simstep_fused_chunk(
    const void* big, const void* cs_dur, const void* nc_dur,
    const void* inter, const void* seg_lock, const void* slo_scale,
    const void* slo, const void* w_big, const void* prop_n,
    const void* horizon, void* t, void* key, void* phase, void* t_ready,
    void* seg, void* epoch_start, void* attempt_t, void* window, void* unit,
    void* q, void* q_head, void* q_tail, void* holder, void* prop_ctr,
    void* ep_lat, void* ep_cnt, void* cs_lat, void* cs_cnt, void* events,
    int n_cells, int n, int s, int l, int cap, int policy, int chunk,
    int max_events, float unit_mul, float max_window, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.big = static_cast<const int*>(big);
  a.cs_dur = static_cast<const int*>(cs_dur);
  a.nc_dur = static_cast<const int*>(nc_dur);
  a.inter = static_cast<const int*>(inter);
  a.seg_lock = static_cast<const int*>(seg_lock);
  a.slo_scale = static_cast<const float*>(slo_scale);
  a.slo = static_cast<const float*>(slo);
  a.w_big = static_cast<const float*>(w_big);
  a.prop_n = static_cast<const int*>(prop_n);
  a.horizon = static_cast<const int*>(horizon);
  a.t = static_cast<int*>(t);
  a.key = static_cast<long long*>(key);
  a.phase = static_cast<int*>(phase);
  a.t_ready = static_cast<int*>(t_ready);
  a.seg = static_cast<int*>(seg);
  a.epoch_start = static_cast<int*>(epoch_start);
  a.attempt_t = static_cast<int*>(attempt_t);
  a.window = static_cast<float*>(window);
  a.unit = static_cast<float*>(unit);
  a.q = static_cast<int*>(q);
  a.q_head = static_cast<int*>(q_head);
  a.q_tail = static_cast<int*>(q_tail);
  a.holder = static_cast<int*>(holder);
  a.prop_ctr = static_cast<int*>(prop_ctr);
  a.ep_lat = static_cast<float*>(ep_lat);
  a.ep_cnt = static_cast<int*>(ep_cnt);
  a.cs_lat = static_cast<float*>(cs_lat);
  a.cs_cnt = static_cast<int*>(cs_cnt);
  a.events = static_cast<int*>(events);
  a.n_cells = n_cells;
  a.n = n;
  a.s = s;
  a.l = l;
  a.cap = cap;
  a.policy = policy;
  a.chunk = chunk;
  a.max_events = max_events;
  a.unit_mul = unit_mul;
  a.max_window = max_window;
  const int blocks = (n_cells + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_chunk_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* simstep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
