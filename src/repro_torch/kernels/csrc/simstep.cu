// Hand-written Hopper (sm_90a) kernel for the lock simulator's event loop.
//
// Replaces the TPU kernel repro/kernels/simstep.py::fused_chunk, which
// retires `chunk` events of the engine's masked step inside one
// pallas_call with the packed state held in VMEM.  This kernel does the
// same work for a batch of sweep cells: each launch advances every cell by
// up to `chunk` events of the closed-loop step (acquire, release, standby
// expiry) under the fifo / tas / prop / libasl / edf / shfl / dvfs_race
// hooks, one instantiation per policy and one for merged policy sets that
// switches on each cell's policy id at every hook (a warp is one cell, so
// the branch is uniform).  Three runtime gates, read once per launch, add
// the long-epoch draw, the blocking-lock wakeup on queue-pop handoffs and
// the energy integration.  Results are bit-identical to the plain PyTorch
// step (repro_torch/core/simlock.py::_step) and to the JAX package.
//
// What bounds it on this card: each cell is one serial chain of events.
// Per launch a cell's state is read once and written once (a few hundred
// bytes; 0.45 us for the main path's 1,024 cells at 3.35 TB/s), and each
// recorded latency is one 4-byte ring store.  What limits a cell is the
// latency of its dependent chain: per event, a warp min (redux.sync) and
// ballot over the lanes' t_ready for the head of the clock, then the
// handler's chain of dependent shared-memory loads (phase -> lock ->
// holder / queue head and tail -> queue slot -> seg -> cs_dur), about 4
// to 8 loads of ~30 cycles each, and a 64-bit multiply for each queue
// slot and ring index (x mod n, x mod cap, by Lemire's method); a tas /
// libasl release adds three threefry2x32 blocks (two of them
// independent), about 2 x 20 rounds of three dependent integer ops.  So
// an event takes a few hundred cycles, not the ~2,000 that the same chain
// costs through device memory; the card is filled only by running many
// cells at once.
//
// What the design does about it: one warp per cell, lane = core.  At
// launch start the warp checks that its cell is live (a cell that is not
// loads nothing more and stores nothing), then stages the cell in shared
// memory: its per-core state and tables, each core's lock (seg_lock[seg],
// kept up to date), its queues with their heads and tails, holders and
// proportional counters; its key, clock, event count and params go to
// registers, and each lane keeps its own core's t_ready in a register
// (the handlers only write t_ready).  Every lane runs the handlers on the same
// values (stores of one value to one shared address from all lanes, so
// each lane sees every store in its own program order); the lanes work
// apart only where the step is per core: each lane offers its own
// t_ready for the head of the clock (lowest core on ties, as jnp.argmin,
// by the ballot's first lane); in tas / libasl's pick_next each lane
// computes its own core's weight; edf / shfl / dvfs_race scan the waiters
// as a warp min (max) over each lane's key, the first lane at it winning;
// and each lane integrates its own core's energy in a register, its
// phase powers and edf / dvfs_race's per-core terms set once per launch.  The
// weights' prefix sum stays left to right in f32 (each lane runs the same
// serial sum over the weights in shared memory and keeps its own core's
// partial), so the pick is bit-identical to the plain version's cumsum.
// The latency rings stay in device memory, written by lane 0 and never
// read.  The mutable state goes back to device memory once, at the end.
// The stage's shared-memory base, the launch's sizes and the ring moduli
// are held in registers behind empty asm statements: left to itself,
// ptxas re-derived them from the CTA id and the constant bank in every
// event once the kernel grew its gates (fifo and prop ~25 % slower a
// launch on small grids until they were pinned).
// Shared memory per cell: (13 n + 2 n s + s + 2 l n + 8 l + 32) words for
// n cores, s segments and l locks (the long-epoch scales and shfl /
// dvfs_race's counters took n + 2 l of it); up to four cells (warps) a
// block.
//
// Bit-exactness: build with -fmad=false (no a*b+c contraction), keep the
// reference's compiled f32 operation order (its AIMD unit is one multiply
// by a folded constant; its energy update one FMA, written as fmaf),
// truncate f32->i32 toward zero, take the weighted-pick prefix sum left to
// right, split the RNG key on every release when long epochs are on and
// then again in tas / libasl's pick (even when no standby pick follows),
// and commit nothing of a merged set's other members.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kNonCrit = 0, kStandby = 1, kQueued = 2, kHolder = 3,
              kSpin = 4;
constexpr int kInf = 1 << 30;
// Policy ids (the registry's order); kMerged is the merged sets'
// instantiation, which reads each cell's id.
constexpr int kFifo = 0, kTas = 1, kProp = 2, kLibasl = 3, kEdf = 4,
              kShfl = 5, kDvfsRace = 6, kMerged = 7;
constexpr int kMaxWarpsPerBlock = 4;
constexpr int kSmemLimit = 232448;  // dynamic shared memory of one block
constexpr unsigned kFull = 0xffffffffu;

// The operands, in this order (the wrapper's _ORDER): tables, params,
// state.  All cell-major and contiguous.
// Null where the launch's gates and policies do not read them: pol_id
// (merged sets), long_prob, long_scale and scale (long epochs), wakeup,
// the power tables, n_active and energy (the energy model), dvfs (energy,
// dvfs_race), race_w, race_bound and race_ctr (dvfs_race), shfl_bound and
// shfl_ctr (shfl).
enum Operand {
  kBig, kCsDur, kNcDur, kInter, kSegLock, kSloScale, kDvfs, kRaceW, kPCs,
  kPSpin, kPPark, kPIdle,
  kSlo, kPolId, kWBig, kPropN, kNActive, kHorizon, kLongProb, kLongScale,
  kWakeup, kShflBound, kRaceBound,
  kT, kKey, kPhase, kTReady, kSeg, kEpochStart, kAttemptT, kWindow, kUnit,
  kScale, kQ, kQHead, kQTail, kHolderOp, kPropCtr, kShflCtr, kRaceCtr,
  kEpLat, kEpCnt, kCsLat, kCsCnt, kEvents, kEnergy, kNumOperands
};

// x mod d for 32-bit x >= 0 by two multiplies (Lemire, Kaser and Kurz,
// "Faster remainder by direct computation", 2019): m = 2^64 / d rounded
// up, computed once on the host; exact for every 32-bit x (d = 1: m wraps
// to 0 and so does the result).
struct FastMod {
  unsigned long long m;
  unsigned d;
};

FastMod fast_mod(unsigned d) { return {~0ull / d + 1, d}; }

__device__ __forceinline__ int mod(int x, FastMod f) {
  return static_cast<int>(
      __umul64hi(f.m * static_cast<unsigned>(x), f.d));
}

struct Args {
  void* p[kNumOperands];
  int n_cells, n, s, l, cap, chunk, max_events;
  int long_on, wakeup_on, energy_on;  // the gates, uniform per launch
  float unit_mul, max_window;
  FastMod mod_n, mod_cap;
};

// Words of shared memory one cell takes (see the header).
__host__ __device__ constexpr int cell_words(int n, int s, int l) {
  return 13 * n + 2 * n * s + s + 2 * l * n + 8 * l + 32;
}

// One cell: pointers into its shared-memory stage, its rings in device
// memory, and what stays in registers.
struct Cell {
  // mutable, staged
  int* phase;
  int* lk;           // each core's lock, seg_lock[seg] (not written back)
  int* seg;
  int* epoch_start;
  int* attempt_t;
  int* ep_cnt;
  int* cs_cnt;
  float* window;
  float* unit;
  float* scale;      // each core's long-epoch scale
  int* q;
  int* q_head;
  int* q_tail;
  int* holder;
  int* prop_ctr;
  int* shfl_ctr;
  int* race_ctr;
  // read-only, staged
  int* big;
  int* inter;
  float* slo_scale;
  int* cs_dur;
  int* nc_dur;
  int* seg_lock;
  float* wbuf;       // one weight per lane (pick_next)
  // device memory
  float* ep_lat;
  float* cs_lat;
  // registers
  int tr;            // this lane's core's t_ready
  int slo_t;         // this lane's core's SLO in ticks, capped (edf)
  float score;       // this lane's core's race score (dvfs_race)
  uint32_t k0, k1;
  float slo, w_big, long_prob, long_scale;
  int prop_n, pol, wakeup, shfl_bound, race_bound;
  int n, s, cap, lane;
  bool long_on;
  FastMod mod_n, mod_cap;
  float unit_mul, max_window;
};

// Carve one cell's stage out of `base` (cell_words(n, s, l) words).
__device__ __forceinline__ void carve(Cell& c, int* base, int n, int s,
                                      int l) {
  int* p = base;
  c.phase = p;        p += n;
  c.lk = p;           p += n;
  c.seg = p;          p += n;
  c.epoch_start = p;  p += n;
  c.attempt_t = p;    p += n;
  c.ep_cnt = p;       p += n;
  c.cs_cnt = p;       p += n;
  c.window = reinterpret_cast<float*>(p);     p += n;
  c.unit = reinterpret_cast<float*>(p);       p += n;
  c.scale = reinterpret_cast<float*>(p);      p += n;
  c.big = p;          p += n;
  c.inter = p;        p += n;
  c.slo_scale = reinterpret_cast<float*>(p);  p += n;
  c.cs_dur = p;       p += n * s;
  c.nc_dur = p;       p += n * s;
  c.seg_lock = p;     p += s;
  c.q = p;            p += 2 * l * n;
  c.q_head = p;       p += 2 * l;
  c.q_tail = p;       p += 2 * l;
  c.holder = p;       p += l;
  c.prop_ctr = p;     p += l;
  c.shfl_ctr = p;     p += l;
  c.race_ctr = p;     p += l;
  c.wbuf = reinterpret_cast<float*>(p);
}

// Copy `count` 4-byte words between a warp's lanes.
template <typename T>
__device__ __forceinline__ void warp_copy(T* dst, const T* src, int count,
                                          int lane) {
#pragma unroll 1
  for (int i = lane; i < count; i += 32) dst[i] = src[i];
}

// ---------------------------------------------------------------- RNG ----
// threefry2x32, 20 rounds: jax.random's default block.

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
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
__device__ __forceinline__ void advance_key(Cell& c, uint32_t& s0,
                                            uint32_t& s1) {
  uint32_t n0 = 0, n1 = 0;
  threefry2x32(c.k0, c.k1, n0, n1);
  s0 = 0;
  s1 = 1;
  threefry2x32(c.k0, c.k1, s0, s1);
  c.k0 = n0;
  c.k1 = n1;
}

// jax.random.uniform(key): 23 random mantissa bits under exponent 0.
__device__ __forceinline__ float uniform01(uint32_t k0, uint32_t k1) {
  uint32_t y0 = 0, y1 = 0;
  threefry2x32(k0, k1, y0, y1);
  const uint32_t bits = ((y0 ^ y1) >> 9) | 0x3F800000u;
  return fmaxf(0.0f, __fsub_rn(__uint_as_float(bits), 1.0f));
}

// First core whose left-to-right f32 prefix sum of the lanes' weights
// `w` exceeds u * total (0 when none does); `any` is total > 0.  Every
// lane runs the same serial sum over the weights in shared memory, eight
// loads ahead of the adds, and keeps the partial at its own core; a
// ballot then finds the first.  Lanes past the cores weigh +0, which
// leaves a sum of non-negative weights unchanged.
__device__ __forceinline__ int weighted_pick(Cell& c, float w, uint32_t s0,
                                             uint32_t s1, bool& any) {
  c.wbuf[c.lane] = c.lane < c.n ? w : 0.0f;
  __syncwarp();
  float acc = 0.0f, mine = 0.0f;
  for (int j0 = 0; j0 < c.n; j0 += 8) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = c.wbuf[j0 + u];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      acc = j0 + u == 0 ? x[0] : __fadd_rn(acc, x[u]);
      if (j0 + u == c.lane) mine = acc;
    }
  }
  const float u = __fmul_rn(uniform01(s0, s1), acc);
  any = acc > 0.0f;
  const unsigned over = __ballot_sync(kFull, c.lane < c.n && mine > u);
  __syncwarp();                 // wbuf is read before the next pick
  return over ? __ffs(over) - 1 : 0;
}

// ------------------------------------------------------------ helpers ----

__device__ __forceinline__ int qlen(const Cell& c, int l, int b) {
  return c.q_tail[l * 2 + b] - c.q_head[l * 2 + b];
}

__device__ __forceinline__ void enq(Cell& c, int l, int b, int core) {
  const int i = l * 2 + b;
  const int tail = c.q_tail[i];
  c.q[i * c.n + mod(tail, c.mod_n)] = core;
  c.q_tail[i] = tail + 1;
}

__device__ __forceinline__ int deq(Cell& c, int l, int b) {
  const int i = l * 2 + b;
  const int head = c.q_head[i];
  if (c.q_tail[i] <= head) return -1;
  c.q_head[i] = head + 1;
  return c.q[i * c.n + mod(head, c.mod_n)];
}

__device__ __forceinline__ int lock_of(const Cell& c, int core) {
  return c.lk[core];
}

// t_ready[core] = v: the lane of that core keeps it in a register.
__device__ __forceinline__ void set_ready(Cell& c, int core, int v) {
  if (c.lane == core) c.tr = v;
}

// Make `core` the holder of its segment's lock; schedule its release.  A
// queue-pop handoff (`handoff`) pays the wakeup when that gate is on.
__device__ __forceinline__ void grant(Cell& c, int core, int t,
                                      bool handoff = false) {
  c.holder[c.lk[core]] = core;
  c.phase[core] = kHolder;
  const int dur = c.cs_dur[core * c.s + c.seg[core]];
  set_ready(c, core, t + (handoff ? dur + c.wakeup : dur));
}

__device__ __forceinline__ void park(Cell& c, int core, int ph) {
  c.phase[core] = ph;
  set_ready(c, core, kInf);
}

// One latency sample into `core`'s ring (device memory, lane 0).
__device__ __forceinline__ void record(const Cell& c, float* buf, int* cnt,
                                       int core, float v) {
  const int k = cnt[core];
  if (c.lane == 0)
    buf[static_cast<size_t>(core) * c.cap + mod(k, c.mod_cap)] = v;
  cnt[core] = k + 1;
}

// Is this lane's core parked in QUEUED on lock l (edf / shfl / dvfs_race's
// waiter set)?
__device__ __forceinline__ bool waiting(const Cell& c, int l) {
  return c.lane < c.n && c.phase[c.lane] == kQueued && c.lk[c.lane] == l;
}

// The first lane holding the warp's least `key` (lane 0 when every key is
// the same), as jnp.argmin picks the lowest index.
__device__ __forceinline__ int first_min(int key) {
  const int m = __reduce_min_sync(kFull, key);
  return __ffs(__ballot_sync(kFull, key == m)) - 1;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// ------------------------------------------------------------ handlers ---

template <int P>
__device__ __forceinline__ void acquire(Cell& c, int core, int t) {
  const int l = lock_of(c, core);
  const bool free = c.holder[l] == -1;
  if (P == kFifo) {
    if (free && qlen(c, l, 0) == 0) {
      grant(c, core, t);
    } else {
      enq(c, l, 0, core);
      park(c, core, kQueued);
    }
  } else if (P == kTas) {
    if (free) {
      grant(c, core, t);
    } else {
      park(c, core, kSpin);
    }
  } else if (P == kProp) {
    if (free && qlen(c, l, 0) == 0 && qlen(c, l, 1) == 0) {
      grant(c, core, t);
    } else {
      enq(c, l, c.big[core] == 1 ? 0 : 1, core);
      park(c, core, kQueued);
    }
  } else if (P == kLibasl) {
    if (free && qlen(c, l, 0) == 0) {
      grant(c, core, t);
    } else if (c.big[core] == 1) {
      enq(c, l, 0, core);
      park(c, core, kQueued);
    } else {
      // Little core: stand by for the (capped) reorder window.
      const int win = static_cast<int>(fminf(c.window[core], c.max_window));
      c.phase[core] = kStandby;
      set_ready(c, core, t + max(win, 0));
    }
  } else {  // edf, shfl, dvfs_race: queue-less
    const bool any_waiting = __any_sync(kFull, waiting(c, l));
    if (free && !any_waiting) {
      grant(c, core, t);
    } else {
      park(c, core, kQueued);
    }
  }
}

__device__ __forceinline__ void standby_expiry(Cell& c, int core, int t) {
  const int l = lock_of(c, core);
  if (c.holder[l] == -1 && qlen(c, l, 0) == 0) {
    grant(c, core, t);
  } else {
    enq(c, l, 0, core);
    park(c, core, kQueued);
  }
}

// Algorithm 2 (libasl, little cores, at an epoch end).
__device__ __forceinline__ void aimd(Cell& c, int core, float latency) {
  float w = c.window[core];
  float u = c.unit[core];
  if (latency > __fmul_rn(c.slo, c.slo_scale[core])) {
    w = __fmul_rn(w, 0.5f);
    u = __fmul_rn(w, c.unit_mul);  // unit_factor(pct), see aimd.py
  }
  c.window[core] = fminf(fmaxf(__fadd_rn(w, u), 0.0f), c.max_window);
  c.unit[core] = u;
}

// shfl / dvfs_race: grant `pick` (when anyone waits) and count the grants
// in a row that bypassed the FIFO `head`.
__device__ __forceinline__ void bounded_grant(Cell& c, int* ctr, int l,
                                              int pick, int head, int t) {
  if (__any_sync(kFull, waiting(c, l))) {
    ctr[l] = pick != head ? ctr[l] + 1 : 0;
    grant(c, pick, t, true);
  }
}

template <int P>
__device__ __forceinline__ void pick_next(Cell& c, int l, int t) {
  const int j = c.lane;
  if (P == kFifo) {
    if (qlen(c, l, 0) > 0) grant(c, deq(c, l, 0), t, true);
  } else if (P == kTas) {
    // Each lane weighs its own core.
    const float w = (j < c.n && c.phase[j] == kSpin && lock_of(c, j) == l)
                        ? (c.big[j] == 1 ? c.w_big : 1.0f)
                        : 0.0f;
    uint32_t s0, s1;
    advance_key(c, s0, s1);
    bool any;
    const int winner = weighted_pick(c, w, s0, s1, any);
    if (any) grant(c, winner, t);
  } else if (P == kProp) {
    const int nb = qlen(c, l, 0), nl = qlen(c, l, 1);
    if (nb > 0 && (c.prop_ctr[l] < c.prop_n || nl == 0)) {
      c.prop_ctr[l] += 1;
      grant(c, deq(c, l, 0), t, true);
    } else if (nl > 0) {
      c.prop_ctr[l] = 0;
      grant(c, deq(c, l, 1), t, true);
    }
  } else if (P == kLibasl) {
    const bool nonempty = qlen(c, l, 0) > 0;
    if (nonempty) grant(c, deq(c, l, 0), t, true);
    // Queue empty -> a standby core may grab the free lock.
    const float w =
        (j < c.n && c.phase[j] == kStandby && lock_of(c, j) == l) ? 1.0f
                                                                  : 0.0f;
    uint32_t s0, s1;
    advance_key(c, s0, s1);
    bool any;
    const int pick = weighted_pick(c, w, s0, s1, any);
    if (!nonempty && any) grant(c, pick, t);
  } else if (P == kEdf) {
    // Earliest deadline, then earliest attempt, then lowest core.
    // (Every lane reaches each warp collective: none sits behind &&.)
    const bool wt = waiting(c, l);
    const int dl = wt ? c.epoch_start[j] + c.slo_t : kInf;
    const int dl_min = __reduce_min_sync(kFull, dl);
    const bool tie = wt && dl == dl_min;
    const int pick = first_min(tie ? c.attempt_t[j] : kInf);
    if (__any_sync(kFull, wt)) grant(c, pick, t, true);
  } else if (P == kShfl) {
    // A big waiter jumps the FIFO head, at most shfl_bound times in a row.
    const bool wt = waiting(c, l);
    const bool big_wt = wt && c.big[j] == 1;
    const int head = first_min(wt ? c.attempt_t[j] : kInf);
    const int big_head = first_min(big_wt ? c.attempt_t[j] : kInf);
    const bool any_big = __any_sync(kFull, big_wt);
    const bool shuffle = any_big && c.shfl_ctr[l] < c.shfl_bound;
    bounded_grant(c, c.shfl_ctr, l, shuffle ? big_head : head, head, t);
  } else if (P == kDvfsRace) {
    // The highest race score, earliest attempt among equals; the FIFO
    // head once race_bound grants in a row bypassed it.
    const bool wt = waiting(c, l);
    const float score = wt ? c.score : -1.0f;
    const float best = warp_max(score);
    const bool tie = wt && score == best;
    const int fast = first_min(tie ? c.attempt_t[j] : kInf);
    const int head = first_min(wt ? c.attempt_t[j] : kInf);
    bounded_grant(c, c.race_ctr, l,
                  c.race_ctr[l] >= c.race_bound ? head : fast, head, t);
  }
}

// Run hook `F<policy>` of the cell's policy: the instantiation's own, or,
// in the merged instantiation, the one the cell's id names (uniform over
// the warp: a warp is one cell).
#define BY_POLICY(P, F, ...)                                   \
  do {                                                         \
    if constexpr (P == kMerged) {                              \
      switch (c.pol) {                                         \
        case kFifo: F<kFifo>(__VA_ARGS__); break;              \
        case kTas: F<kTas>(__VA_ARGS__); break;                \
        case kProp: F<kProp>(__VA_ARGS__); break;              \
        case kLibasl: F<kLibasl>(__VA_ARGS__); break;          \
        case kEdf: F<kEdf>(__VA_ARGS__); break;                \
        case kShfl: F<kShfl>(__VA_ARGS__); break;              \
        default: F<kDvfsRace>(__VA_ARGS__); break;             \
      }                                                        \
    } else {                                                   \
      F<P>(__VA_ARGS__);                                       \
    }                                                          \
  } while (0)

// A duration of the next epoch's program under its long-epoch scale
// (int(float(d) * scale), truncated); unscaled when long epochs are off.
__device__ __forceinline__ int scaled(const Cell& c, int d, float scale) {
  return c.long_on
             ? static_cast<int>(__fmul_rn(static_cast<float>(d), scale))
             : d;
}

template <int P>
__device__ __forceinline__ void release(Cell& c, int core, int t) {
  const int s = c.seg[core];
  const int l = c.lk[core];
  record(c, c.cs_lat, c.cs_cnt, core,
         static_cast<float>(t - c.attempt_t[core]));
  const bool last = s == c.s - 1;
  const float ep_latency = static_cast<float>(t - c.epoch_start[core]);
  if (last) record(c, c.ep_lat, c.ep_cnt, core, ep_latency);
  const bool libasl = P == kLibasl || (P == kMerged && c.pol == kLibasl);
  if (libasl && last && c.big[core] == 0) aimd(c, core, ep_latency);
  // Long epochs: every release splits the key; an epoch end draws the
  // next epoch's scale of its non-critical work.
  float scale = 1.0f;
  if (c.long_on) {
    uint32_t s0, s1;
    advance_key(c, s0, s1);
    scale = c.scale[core];
    if (last) {
      scale = uniform01(s0, s1) < c.long_prob ? c.long_scale : 1.0f;
      c.scale[core] = scale;
    }
  }
  const int inter = scaled(c, c.inter[core], scale);
  if (last) {
    c.seg[core] = 0;
    c.lk[core] = c.seg_lock[0];
    c.epoch_start[core] = t + inter;
    set_ready(c, core, t + inter + scaled(c, c.nc_dur[core * c.s], scale));
  } else {
    c.seg[core] = s + 1;
    c.lk[core] = c.seg_lock[s + 1];
    set_ready(c, core, t + scaled(c, c.nc_dur[core * c.s +
                                               min(s + 1, c.s - 1)],
                                  scale));
  }
  c.phase[core] = kNonCrit;
  c.holder[l] = -1;
  BY_POLICY(P, pick_next, c, l, t);
}

// One event of one cell (the caller checked that the cell is live).
template <int P>
__device__ __forceinline__ void step(Cell& c, int core, int t) {
  const int ph = c.phase[core];
  if (ph == kNonCrit) {
    c.attempt_t[core] = t;
    BY_POLICY(P, acquire, c, core, t);
  } else if (ph == kHolder) {
    release<P>(c, core, t);
  } else if (ph == kStandby) {
    if (P == kLibasl || (P == kMerged && c.pol == kLibasl))
      standby_expiry(c, core, t);
  } else if (ph == kQueued || ph == kSpin) {
    set_ready(c, core, kInf);  // defensive re-park
  }
}

template <typename T>
__device__ __forceinline__ T* at(const Args& a, Operand k, size_t offset) {
  return static_cast<T*>(a.p[k]) + offset;
}

// An optional operand's pointer, or null where the launch does not pass it.
template <typename T>
__device__ __forceinline__ T* at_opt(const Args& a, Operand k,
                                     size_t offset) {
  return a.p[k] ? static_cast<T*>(a.p[k]) + offset : nullptr;
}

template <int P>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
    fused_chunk_kernel(const Args a, int warps_per_block) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * warps_per_block + w;
  if (b >= a.n_cells) return;  // uniform across the warp
  // Pinned in registers (see the header).
  int n = a.n, s = a.s, l = a.l, chunk = a.chunk, max_events = a.max_events;
  asm volatile("" : "+r"(n), "+r"(s), "+r"(l), "+r"(chunk),
               "+r"(max_events));
  const size_t cb = b, ns = static_cast<size_t>(n) * s;

  // Live at launch start?  A cell that is not loads and stores no more.
  int* g_t_ready = at<int>(a, kTReady, cb * n);
  const int tr0 = lane < n ? g_t_ready[lane] : INT_MAX;
  int events = *at<int>(a, kEvents, cb);
  const int horizon = *at<int>(a, kHorizon, cb);
  if (!(__reduce_min_sync(kFull, tr0) < horizon && events < max_events))
    return;

  // The cell's stage as a 32-bit shared address, pinned in a register.
  unsigned stage = static_cast<unsigned>(
      __cvta_generic_to_shared(smem + w * cell_words(n, s, l)));
  asm volatile("" : "+r"(stage));
  Cell c;
  carve(c, static_cast<int*>(__cvta_shared_to_generic(stage)), n, s, l);
  c.lane = lane;
  c.tr = tr0;
  c.n = n;
  c.s = s;
  c.cap = a.cap;
  c.mod_n = a.mod_n;
  c.mod_cap = a.mod_cap;
  asm volatile("" : "+r"(c.cap), "+l"(c.mod_n.m), "+r"(c.mod_n.d),
               "+l"(c.mod_cap.m), "+r"(c.mod_cap.d));
  c.unit_mul = a.unit_mul;
  c.max_window = a.max_window;
  c.long_on = a.long_on != 0;
  c.slo = *at<float>(a, kSlo, cb);
  c.pol = P == kMerged ? *at<int>(a, kPolId, cb) : P;
  c.w_big = *at<float>(a, kWBig, cb);
  c.prop_n = *at<int>(a, kPropN, cb);
  c.long_prob = c.long_on ? *at<float>(a, kLongProb, cb) : 0.0f;
  c.long_scale = c.long_on ? *at<float>(a, kLongScale, cb) : 1.0f;
  c.wakeup = a.wakeup_on ? *at<int>(a, kWakeup, cb) : 0;
  const int* g_shfl_bound = at_opt<int>(a, kShflBound, cb);
  const int* g_race_bound = at_opt<int>(a, kRaceBound, cb);
  c.shfl_bound = g_shfl_bound ? *g_shfl_bound : 0;
  c.race_bound = g_race_bound ? *g_race_bound : 0;
  const long long* g_key = at<long long>(a, kKey, 2 * cb);
  c.k0 = static_cast<uint32_t>(g_key[0]);
  c.k1 = static_cast<uint32_t>(g_key[1]);
  int t = *at<int>(a, kT, cb);
  c.ep_lat = at<float>(a, kEpLat, cb * n * a.cap);
  c.cs_lat = at<float>(a, kCsLat, cb * n * a.cap);

  // Stage the cell: every load of a pass is issued before its stores, so
  // each pass costs one round trip to device memory.  Each lane keeps its
  // own core's per-launch constants in registers.
  const size_t cn = cb * n, cl = cb * l, cq = cb * 2 * l;
  const bool active = a.energy_on && lane < *at<int>(a, kNActive, cb);
  const float* g_dvfs = at_opt<float>(a, kDvfs, cn);
  const float* g_race_w = at_opt<float>(a, kRaceW, cn);
  float energy = 0.0f, p_act = 0.0f, p_spin = 0.0f, p_park = 0.0f,
        p_idle = 0.0f;
  if (lane < n) {
    const int phase = at<int>(a, kPhase, cn)[lane];
    const int seg = at<int>(a, kSeg, cn)[lane];
    const int epoch_start = at<int>(a, kEpochStart, cn)[lane];
    const int attempt_t = at<int>(a, kAttemptT, cn)[lane];
    const int ep_cnt = at<int>(a, kEpCnt, cn)[lane];
    const int cs_cnt = at<int>(a, kCsCnt, cn)[lane];
    const float window = at<float>(a, kWindow, cn)[lane];
    const float unit = at<float>(a, kUnit, cn)[lane];
    const float scale = c.long_on ? at<float>(a, kScale, cn)[lane] : 1.0f;
    const int big = at<int>(a, kBig, cn)[lane];
    const int inter = at<int>(a, kInter, cn)[lane];
    const float slo_scale = at<float>(a, kSloScale, cn)[lane];
    const float dvfs = g_dvfs ? g_dvfs[lane] : 1.0f;
    c.phase[lane] = phase;
    c.seg[lane] = seg;
    c.epoch_start[lane] = epoch_start;
    c.attempt_t[lane] = attempt_t;
    c.ep_cnt[lane] = ep_cnt;
    c.cs_cnt[lane] = cs_cnt;
    c.window[lane] = window;
    c.unit[lane] = unit;
    c.scale[lane] = scale;
    c.big[lane] = big;
    c.inter[lane] = inter;
    c.slo_scale[lane] = slo_scale;
    // edf's deadline offset: the SLO in ticks, capped, truncated.
    c.slo_t = static_cast<int>(
        fminf(__fmul_rn(c.slo, slo_scale), a.max_window));
    // dvfs_race's score: race_w * dvfs * (1 + big).
    if (g_race_w)
      c.score = __fmul_rn(__fmul_rn(g_race_w[lane], dvfs),
                          __fadd_rn(1.0f, static_cast<float>(big)));
    if (a.energy_on) {
      energy = at<float>(a, kEnergy, cn)[lane];
      const float f3 = __fmul_rn(__fmul_rn(dvfs, dvfs), dvfs);
      p_act = __fmul_rn(at<float>(a, kPCs, cn)[lane], f3);
      p_spin = __fmul_rn(at<float>(a, kPSpin, cn)[lane], f3);
      p_park = at<float>(a, kPPark, cn)[lane];
      p_idle = at<float>(a, kPIdle, cn)[lane];
    }
  }
  const int* g_cs_dur = at<int>(a, kCsDur, cb * ns);
  const int* g_nc_dur = at<int>(a, kNcDur, cb * ns);
  const int* g_seg_lock = at<int>(a, kSegLock, cb * s);
  const int* g_q = at<int>(a, kQ, cq * n);
  const int* g_q_head = at<int>(a, kQHead, cq);
  const int* g_q_tail = at<int>(a, kQTail, cq);
  const int* g_holder = at<int>(a, kHolderOp, cl);
  const int* g_prop_ctr = at<int>(a, kPropCtr, cl);
  int* g_shfl_ctr = at_opt<int>(a, kShflCtr, cl);
  int* g_race_ctr = at_opt<int>(a, kRaceCtr, cl);
  const int n_ns = n * s, n_q = 2 * l * n;
#pragma unroll 1
  for (int i = lane; i < max(n_ns, n_q); i += 32) {
    const int cs = i < n_ns ? g_cs_dur[i] : 0;
    const int nc = i < n_ns ? g_nc_dur[i] : 0;
    const int sl = i < s ? g_seg_lock[i] : 0;
    const int qv = i < n_q ? g_q[i] : 0;
    const int qh = i < 2 * l ? g_q_head[i] : 0;
    const int qt = i < 2 * l ? g_q_tail[i] : 0;
    const int ho = i < l ? g_holder[i] : 0;
    const int pc = i < l ? g_prop_ctr[i] : 0;
    const int sc = i < l && g_shfl_ctr ? g_shfl_ctr[i] : 0;
    const int rc = i < l && g_race_ctr ? g_race_ctr[i] : 0;
    if (i < n_ns) {
      c.cs_dur[i] = cs;
      c.nc_dur[i] = nc;
    }
    if (i < s) c.seg_lock[i] = sl;
    if (i < n_q) c.q[i] = qv;
    if (i < 2 * l) {
      c.q_head[i] = qh;
      c.q_tail[i] = qt;
    }
    if (i < l) {
      c.holder[i] = ho;
      c.prop_ctr[i] = pc;
      c.shfl_ctr[i] = sc;
      c.race_ctr[i] = rc;
    }
  }
  __syncwarp();
  if (lane < n) c.lk[lane] = c.seg_lock[c.seg[lane]];
  __syncwarp();

  for (int it = 0; it < chunk; ++it) {
    // Head of the event clock: min t_ready, lowest core on ties.
    const int tr = lane < n ? c.tr : INT_MAX;
    const int t_min = __reduce_min_sync(kFull, tr);
    if (!(t_min < horizon && events < max_events)) break;
    const int core = __ffs(__ballot_sync(kFull, tr == t_min)) - 1;
    if (a.energy_on && lane < n) {
      // This lane's core spent the clock's advance in its phase.
      const int ph = c.phase[lane];
      const float p =
          !active ? p_idle
          : ph == kNonCrit || ph == kHolder ? p_act
          : ph == kSpin || ph == kStandby   ? p_spin
          : ph == kQueued                   ? p_park
                                            : p_idle;
      energy = fmaf(static_cast<float>(t_min - t), p, energy);
    }
    t = t_min;
    events += 1;
    step<P>(c, core, t);
    __syncwarp();
  }

  // Write the mutable state back once.
  if (lane < n) {
    g_t_ready[lane] = c.tr;
    if (a.energy_on) at<float>(a, kEnergy, cn)[lane] = energy;
  }
  warp_copy(at<int>(a, kPhase, cn), c.phase, n, lane);
  warp_copy(at<int>(a, kSeg, cn), c.seg, n, lane);
  warp_copy(at<int>(a, kEpochStart, cn), c.epoch_start, n, lane);
  warp_copy(at<int>(a, kAttemptT, cn), c.attempt_t, n, lane);
  warp_copy(at<int>(a, kEpCnt, cn), c.ep_cnt, n, lane);
  warp_copy(at<int>(a, kCsCnt, cn), c.cs_cnt, n, lane);
  warp_copy(at<float>(a, kWindow, cn), c.window, n, lane);
  warp_copy(at<float>(a, kUnit, cn), c.unit, n, lane);
  if (c.long_on) warp_copy(at<float>(a, kScale, cn), c.scale, n, lane);
  warp_copy(at<int>(a, kQ, cq * n), c.q, 2 * l * n, lane);
  warp_copy(at<int>(a, kQHead, cq), c.q_head, 2 * l, lane);
  warp_copy(at<int>(a, kQTail, cq), c.q_tail, 2 * l, lane);
  warp_copy(at<int>(a, kHolderOp, cl), c.holder, l, lane);
  warp_copy(at<int>(a, kPropCtr, cl), c.prop_ctr, l, lane);
  if (g_shfl_ctr) warp_copy(g_shfl_ctr, c.shfl_ctr, l, lane);
  if (g_race_ctr) warp_copy(g_race_ctr, c.race_ctr, l, lane);
  if (lane == 0) {
    *at<int>(a, kT, cb) = t;
    *at<int>(a, kEvents, cb) = events;
    long long* key = at<long long>(a, kKey, 2 * cb);
    key[0] = static_cast<long long>(c.k0);
    key[1] = static_cast<long long>(c.k1);
  }
}

template <int P>
int launch(const Args& a, cudaStream_t stream) {
  const int bytes = 4 * cell_words(a.n, a.s, a.l);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = min(kMaxWarpsPerBlock, kSmemLimit / bytes);
  const int smem = warps * bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_chunk_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (a.n_cells + warps - 1) / warps;
  fused_chunk_kernel<P><<<blocks, warps * 32, smem, stream>>>(a, warps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory of one cell, in bytes: the wrapper raises by name where a
// shape does not fit one block.
int simstep_cell_bytes(int n, int s, int l) { return 4 * cell_words(n, s, l); }

// Advance every cell by up to `chunk` events on `stream`.  `operands`
// holds the 46 device pointers (tables, params, state; the wrapper's
// _ORDER) into contiguous cell-major tensors, the pol slots null where no
// policy of the launch has them; `ints` holds n_cells, n, s, l, cap,
// policy (its id, or -1 for a merged set), chunk, max_events and the
// long-epoch, wakeup and energy gates; `floats` the AIMD unit factor and
// the window cap.  Returns the cudaError_t of the launch (0 = success);
// the caller raises on anything else.
int simstep_fused_chunk(void* const* operands, const int* ints,
                        const float* floats, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  for (int k = 0; k < kNumOperands; ++k) a.p[k] = operands[k];
  a.n_cells = ints[0];
  a.n = ints[1];
  a.s = ints[2];
  a.l = ints[3];
  a.cap = ints[4];
  a.chunk = ints[6];
  a.max_events = ints[7];
  a.long_on = ints[8];
  a.wakeup_on = ints[9];
  a.energy_on = ints[10];
  a.unit_mul = floats[0];
  a.max_window = floats[1];
  a.mod_n = fast_mod(static_cast<unsigned>(a.n));
  a.mod_cap = fast_mod(static_cast<unsigned>(a.cap));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ints[5]) {
    case kFifo:
      return launch<kFifo>(a, st);
    case kTas:
      return launch<kTas>(a, st);
    case kProp:
      return launch<kProp>(a, st);
    case kLibasl:
      return launch<kLibasl>(a, st);
    case kEdf:
      return launch<kEdf>(a, st);
    case kShfl:
      return launch<kShfl>(a, st);
    case kDvfsRace:
      return launch<kDvfsRace>(a, st);
    case -1:
      return launch<kMerged>(a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* simstep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
