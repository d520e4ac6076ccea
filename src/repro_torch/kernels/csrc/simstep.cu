// Hand-written Hopper (sm_90a) kernel for the lock simulator's event loop.
//
// Replaces the TPU kernel repro/kernels/simstep.py::fused_chunk, which
// retires `chunk` events of the engine's masked step inside one
// pallas_call with the packed state held in VMEM.  This kernel does the
// same work for a batch of sweep cells: each launch advances every cell by
// up to `chunk` events of the closed-loop step (acquire, release, standby
// expiry) under the fifo / tas / prop / libasl / edf / shfl / dvfs_race /
// ks_erew / ks_crew / ks_jbsq hooks, one instantiation per policy and one
// for merged policy sets that switches on each cell's policy id at every
// hook (a warp is one cell, so the branch is uniform).  Three runtime
// gates, read once per launch, add the long-epoch draw, the blocking-lock
// wakeup on queue-pop handoffs and the energy integration.  A second
// template parameter gives each policy (and the merged set) a stochastic
// instantiation, which alone compiles
// the workload draws (wl: closed-loop think, service, MMPP phase; wl_open:
// the ARRIVAL event and its gaps), the streaming histograms (hist) and the
// faults (holder preemption, core churn, straggler spikes) and the
// key-sharded draws (each epoch's lock from a Zipf key, and ks_crew's
// read/write class), each under a runtime gate of its own; the other
// instantiations, the fig1 main path's, compile none of it.  Results are
// bit-identical to the plain PyTorch step
// (repro_torch/core/simlock.py::_step) and to the JAX package.
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
// cells at once.  A stochastic epoch end adds up to four counter draws of
// two threefry blocks each (independent, so their chains overlap) and
// XLA's f32 log1p / erf_inv / exp polynomials, a chain of ~150 dependent
// f32 operations; a grant under the faults adds up to two draws.
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
// The stochastic instantiations: each draw is uniform(fold_in(counter_key(
// stream_key(seed, S), core), index)), and each lane folds its own core
// into the keys of the streams the launch's gates use once a launch (two
// threefry blocks a stream), keeping them in registers; a handler for
// core c reads lane c's key with __shfl_sync (every lane runs the
// handlers, so every lane reaches the shuffle), and a draw then costs two
// blocks.  Per core they stage the service scale, MMPP phase bit and next
// arrival (mutable) and the service-id column and fault mask; the
// histograms stay in device memory like the latency rings (2 x n x 512
// words a cell, too much to stage), each sample one increment of one
// word by lane 0 (a cell is one warp: no atomics).  The transcendentals
// are XLA's own f32 polynomials (below), never CUDA's log1pf / erfinvf /
// expf / log2f.
// Keyed traffic (n_keys > 0) makes each core's lock state: `lk` holds its
// epoch's drawn lock (cur_lock), staged and written back, drawn at each
// epoch end (closed loop) or arrival (open loop) by uniform(fold_in(
// counter_key(stream_key(seed, KEY), core), epoch)) through the Zipf
// inverse CDF in XLA's f32 operations (its one fused multiply-add, fmaf)
// and glibc's powf written out in doubles (xla_powf below, its nine FMAs
// as __fma_rn, its tables in constant memory; never CUDA's powf).  The
// ks_* picks are warp collectives: a lock's owner is the position l mod
// n_active in the stable order active bigs, active littles, the rest
// (two ballots and popc, then one ballot for the lane at it); ks_jbsq's
// least served waiter a warp min of ep_cnt, then of attempt_t.  The
// keyed operands (the Zipf params, the policies' knobs, cur_lock, cur_rw
// and the three bypass counters) come in ArgsK, an extension of Args
// that only keyed launches take (keys on, or a ks_* policy in the set; an
// overload of the kernel and an instantiation of its own), so every
// instantiation the parent had compiles as before: every keyed path sits
// behind `if constexpr`, since even a runtime gate that folds to false
// changed their code (a bool kept as a predicate, not a u16).
// Shared memory per cell: (13 n + 2 n s + s + 2 l n + 8 l + 32) words for
// n cores, s segments and l locks, 5 n more in a stochastic
// instantiation (the long-epoch scales and shfl / dvfs_race's counters
// took n + 2 l of it) and 5 n + 3 l + 11 more in an instantiation that
// takes ArgsK (cur_rw, the stream keys of the key draws, the ks_*
// counters and the keyed params, staged rather than held in registers,
// where they pushed the stochastic instantiations past 128 registers into
// spills); up to four cells (warps) a block.
//
// Bit-exactness: build with -fmad=false (no a*b+c contraction), keep the
// reference's compiled f32 operation order (its AIMD unit is one multiply
// by a folded constant; its energy update one FMA, written as fmaf; the
// FMAs LLVM makes inside XLA's polynomials, in the lognormal, the bimodal
// mix, the diurnal ramp and the histogram's log2, each written as fmaf),
// truncate f32->i32 toward zero, take the weighted-pick prefix sum left to
// right, split the RNG key on every release when long epochs are on and
// then again in tas / libasl's pick (even when no standby pick follows),
// and commit nothing of a merged set's other members.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNonCrit = 0, kStandby = 1, kQueued = 2, kHolder = 3,
              kSpin = 4, kArrival = 5;
constexpr int kInf = 1 << 30;
// Policy ids (the registry's order); kMerged is the merged sets'
// instantiation, which reads each cell's id.
constexpr int kFifo = 0, kTas = 1, kProp = 2, kLibasl = 3, kEdf = 4,
              kShfl = 5, kDvfsRace = 6, kKsErew = 7, kKsCrew = 8,
              kKsJbsq = 9, kMerged = 10;
constexpr int kMaxWarpsPerBlock = 4;
constexpr int kSmemLimit = 232448;  // dynamic shared memory of one block
constexpr unsigned kFull = 0xffffffffu;

// The operands, in this order (the wrapper's _ORDER): tables, params,
// state.  All cell-major and contiguous.
// Null where the launch's gates and policies do not read them: pol_id
// (merged sets), long_prob, long_scale and scale (long epochs; scale also
// under wl), wakeup, the power tables, n_active and energy (the energy
// model), dvfs (energy, dvfs_race), race_w, race_bound and race_ctr
// (dvfs_race), shfl_bound and shfl_ctr (shfl); and the stochastic
// instantiations' operands (after kEnergy), each where its gate is on:
// the seed (any), the wl columns, params and state (wl), the histogram
// layout, warmup and counts (hist), ft_mask with the fault params.
enum Operand {
  kBig, kCsDur, kNcDur, kInter, kSegLock, kSloScale, kDvfs, kRaceW, kPCs,
  kPSpin, kPPark, kPIdle,
  kSlo, kPolId, kWBig, kPropN, kNActive, kHorizon, kLongProb, kLongScale,
  kWakeup, kShflBound, kRaceBound,
  kT, kKey, kPhase, kTReady, kSeg, kEpochStart, kAttemptT, kWindow, kUnit,
  kScale, kQ, kQHead, kQTail, kHolderOp, kPropCtr, kShflCtr, kRaceCtr,
  kEpLat, kEpCnt, kCsLat, kCsCnt, kEvents, kEnergy,
  // tables
  kWlServiceCol, kFtMask, kHistLog2Lo, kHistInvLog2g,
  // params
  kSeed, kWlProcess, kWlService, kWlRate, kWlCv, kWlMix, kWlMixScale,
  kWlBurst, kWlBurstLen, kWlAmp, kWlPeriod, kPreemptRate, kPreemptScale,
  kChurnRate, kChurnPeriod, kStraggleRate, kStraggleScale, kHistWarmup,
  // state
  kSvcScale, kWlOn, kArrT, kEpHist, kCsHist, kNumOperands
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
  // The stochastic instantiations' gates: workload draws (closed or open
  // loop), open loop, histograms (with their bucket count), preemption,
  // churn and straggling.
  int wl_on, open_on, hist_on, hist_buckets, preempt_on, churn_on,
      straggle_on;
  float unit_mul, max_window;
  FastMod mod_n, mod_cap;
};

// The keyed operands, after Args's in the wrapper's order: the cells' Zipf
// params and active lock counts, the ks_* policies' knobs, and the state
// (each core's lock and read/write uniform, the per-lock bypass
// counters).  Null where the launch's gates and policies do not read them.
enum KeyOperand {
  kKsKeys, kKsTheta, kKsZeta, kKsEta, kKsAlpha, kKsLocks, kErewBound,
  kCrewWfrac, kCrewBound, kJbsqK, kCurLock, kCurRw, kErewCtr, kCrewCtr,
  kJbsqCtr, kNumKeyOperands
};

// Args of the keyed launches' instantiations (keys on, or a ks_* policy
// in the set), and the key gate.
struct ArgsK : Args {
  void* k[kNumKeyOperands];
  int ks_on;
};

// The keyed params a cell stages (ArgsK instantiations): its Zipf
// constants (zeta2 = 1 + 0.5^theta, once a launch) and active lock count,
// and the ks_* policies' knobs with the cell's active core count.
enum KeyParam {
  kpKeys, kpLocks, kpZeta, kpEta, kpAlpha, kpZeta2, kpNActive, kpErewBound,
  kpCrewWfrac, kpCrewBound, kpJbsqK, kNumKeyParams
};

// Words of shared memory one cell takes (see the header): a stochastic
// instantiation stages 5 more per core.
__host__ __device__ constexpr int cell_words(int n, int s, int l,
                                             bool stoch) {
  return 13 * n + 2 * n * s + s + 2 * l * n + 8 * l + 32 + (stoch ? 5 * n : 0);
}

// Words an instantiation that takes ArgsK stages after those.
__host__ __device__ constexpr int keyed_words(int n, int l) {
  return 5 * n + 3 * l + kNumKeyParams;
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
  // stochastic instantiations: mutable, staged
  float* svc_scale;  // each core's epoch service scale (wl)
  int* wl_on;        // each core's MMPP phase bit (wl)
  int* arr_t;        // each core's next open-loop arrival (wl_open)
  // ... read-only, staged
  int* wl_service;   // each core's SERVICES id override, -1 = the cell's
  float* ft_mask;    // each core's fault eligibility
  // ArgsK instantiations: mutable, staged
  float* cur_rw;     // each core's epoch read/write uniform (ks_crew)
  int* erew_ctr;     // each lock's bypasses in a row (ks_erew, ks_crew,
  int* crew_ctr;     // ks_jbsq)
  int* jbsq_ctr;
  // ... read-only, staged
  uint32_t* kkey;    // each core's KEY and RW stream keys (2 words each;
  uint32_t* rwkey;   // keyed draws)
  int* kp;           // the cell's KeyParam values (f32 ones as bits)
  // device memory
  float* ep_lat;
  float* cs_lat;
  int* ep_hist;      // [n, hist_buckets] u32 counts (hist)
  int* cs_hist;
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
  // stochastic instantiations: this lane's core's stream keys (each
  // counter_key(stream_key(seed, S), core)), the gates and the cell's
  // params, in registers.
  uint32_t th0, th1, sv0, sv1, sz0, sz1, ph0, ph1;  // think, service u/z,
                                                    // phase (wl)
  uint32_t pr0, pr1, pz0, pz1, sp0, sp1, ch0, ch1;  // preempt u/stall,
                                                    // spike, churn
  bool wl, open, hist, preempt, churn, straggle, scaled;
  int wl_process, wl_service_cell, churn_period, hist_warmup, hb;
  float wl_rate, wl_cv, wl_mix, wl_mix_scale, wl_burst, wl_burst_len,
      wl_amp, wl_period, preempt_rate, preempt_scale, churn_rate,
      straggle_rate, straggle_scale, log2_lo, inv_log2g;
  // keyed traffic's gates (ks: key draws; rw: this cell's policy reads the
  // rw class); the rest of its state is staged, to keep the registers of
  // the stochastic instantiations where they were.
  bool ks, rw;
};

// Carve one cell's stage out of `base` (cell_words(n, s, l, stoch)
// words).
__device__ __forceinline__ void carve(Cell& c, int* base, int n, int s,
                                      int l, bool stoch) {
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
  c.wbuf = reinterpret_cast<float*>(p);  p += 32;
  if (stoch) {
    c.svc_scale = reinterpret_cast<float*>(p);  p += n;
    c.wl_on = p;        p += n;
    c.arr_t = p;        p += n;
    c.wl_service = p;   p += n;
    c.ft_mask = reinterpret_cast<float*>(p);
  }
}

// Carve the keyed stage (keyed_words(n, l) words) out of `p`.
__device__ __forceinline__ void carve_keyed(Cell& c, int* p, int n, int l) {
  c.cur_rw = reinterpret_cast<float*>(p);   p += n;
  c.erew_ctr = p;     p += l;
  c.crew_ctr = p;     p += l;
  c.jbsq_ctr = p;     p += l;
  c.kkey = reinterpret_cast<uint32_t*>(p);  p += 2 * n;
  c.rwkey = reinterpret_cast<uint32_t*>(p); p += 2 * n;
  c.kp = p;
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

// ------------------------------------------------ XLA's f32 math ----
// The compiled reference's log / log1p / exp / erf_inv: XLA's CPU
// backend inlines these polynomials (no libm), and LLVM fuses a multiply
// into the add that is its only use.  Written here as the same f32
// operations (repro_torch/core/xla_math.py), with fmaf exactly where the
// reference fuses; -fmad=false keeps every other product rounded.

__device__ __forceinline__ float bits_f(uint32_t b) {
  return __uint_as_float(b);
}

__device__ __forceinline__ float xla_log(float x) {
  const float xc = x > bits_f(0x00800000u) ? x : bits_f(0x00800000u);
  const int bits = __float_as_int(xc);
  float e = static_cast<float>((bits >> 23) - 127) + 1.0f;
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  const bool small = m < bits_f(0x3F3504F3u);
  e = e - (small ? 1.0f : 0.0f);
  const float v = (m - 1.0f) + (small ? m : 0.0f);
  const float v2 = v * v, v3 = v2 * v;
  const float y1 = fmaf(fmaf(v, bits_f(0x3D9021BBu), bits_f(0xBDEBD1B8u)), v,
                        bits_f(0x3DEF251Au));
  const float y2 = fmaf(fmaf(v, bits_f(0xBDFE5D4Fu), bits_f(0x3E11E9BFu)), v,
                        bits_f(0xBE2AAE50u));
  const float y3 = fmaf(fmaf(v, bits_f(0x3E4CCEACu), bits_f(0xBE7FFFFCu)), v,
                        bits_f(0x3EAAAAAAu));
  float y = fmaf(fmaf(y1, v3, y2), v3, y3);
  y = fmaf(y, v3, e * bits_f(0xB95E8083u));
  float r = fmaf(e, bits_f(0x3F318000u), (v - v2 * 0.5f) + y);
  if (x == __int_as_float(0x7F800000)) r = x;
  if (x == 0.0f) r = __int_as_float(0xFF800000);
  if (x < 0.0f || x != x) r = __int_as_float(0x7FC00000);
  return r;
}

__device__ __forceinline__ float xla_log1p(float x) {
  const float x2 = x * x;
  float q = 1.0f + x * 0.0f;
  q = fmaf(q, x, bits_f(0x417101ADu));
  q = fmaf(q, x, bits_f(0x42A6185Bu));
  q = fmaf(q, x, bits_f(0x435DC32Du));
  q = fmaf(q, x, bits_f(0x439A8CA3u));
  q = fmaf(q, x, bits_f(0x43586D8Au));
  q = fmaf(q, x, bits_f(0x42707982u));
  float p = bits_f(0x383DE04Bu) + x * 0.0f;
  p = fmaf(p, x, bits_f(0x3EFF40C5u));
  p = fmaf(p, x, bits_f(0x40D284FAu));
  p = fmaf(p, x, bits_f(0x41EF4B9Cu));
  p = fmaf(p, x, bits_f(0x4273CC76u));
  p = fmaf(p, x, bits_f(0x426473ADu));
  p = fmaf(p, x, bits_f(0x41A05101u));
  if (fabsf(x) < bits_f(0x3ED413CDu))
    return x + ((x * x2) * (p / q) + x2 * -0.5f);
  return xla_log(x + 1.0f);
}

__device__ __forceinline__ float xla_exp(float x) {
  x = x >= bits_f(0xC2AF999Au) ? x : bits_f(0xC2AF999Au);
  x = x <= bits_f(0x42B1999Au) ? x : bits_f(0x42B1999Au);
  float n = floorf(fmaf(x, bits_f(0x3FB8AA3Bu), 0.5f));
  n = fminf(fmaxf(n, -127.0f), 127.0f);
  const float r = fmaf(-n, bits_f(0xB95E8083u),
                       fmaf(-n, bits_f(0x3F318000u), x));
  float p = fmaf(r, bits_f(0x39506967u), bits_f(0x3AB743CEu));
  p = fmaf(p, r, bits_f(0x3C088908u));
  p = fmaf(p, r, bits_f(0x3D2AA9C1u));
  p = fmaf(p, r, bits_f(0x3E2AAAAAu));
  p = fmaf(p, r, 0.5f);
  const float y = 1.0f + fmaf(p, r * r, r);
  return y * __int_as_float((static_cast<int>(n) + 127) << 23);
}

__device__ __forceinline__ float xla_erf_inv(float x) {
  const float lg = xla_log1p(x * -x);  // -w
  const bool lt5 = lg > -5.0f;
  const float z = lt5 ? -2.5f - lg : sqrtf(-lg) - 3.0f;
#define C(a, b) (lt5 ? bits_f(a) : bits_f(b))
  float p = fmaf(C(0x32F16588u, 0xB951F09Bu), z, C(0x34B84B36u, 0x38D3B56Bu));
  p = fmaf(z, p, C(0xB66C7357u, 0x3AB0DC72u));
  p = fmaf(z, p, C(0xB6935AC1u, 0xBB70BDE7u));
  p = fmaf(z, p, C(0x396532DBu, 0x3BBC127Bu));
  p = fmaf(z, p, C(0xBAA45408u, 0xBBF9C5D7u));
  p = fmaf(z, p, C(0xBB88E4EFu, 0x3C1AA57Eu));
  p = fmaf(z, p, C(0x3E7C8F63u, 0x3F8036DBu));
  p = fmaf(z, p, C(0x3FC02E2Fu, 0x40354F7Eu));
#undef C
  if (fabsf(x) == 1.0f) p = __int_as_float(0x7F800000);
  return x * p;
}

// sin in f64 (pi/2 in two parts, fdlibm's kernels), rounded once to f32:
// the same f64 operations as xla_math.sin.
__device__ __forceinline__ float sin_f32(float xf) {
  const double x = xf;
  const double k = rint(x * 6.36619772367581382433e-01);
  const double r = (x - k * 1.57079632673412561417e+00)
                   - k * 6.07710050650619224932e-11;
  const double z = r * r;
  const double s = r + (r * z) * (-1.66666666666666324348e-01 +
      z * (8.33333333332248946124e-03 + z * (-1.98412698298579493134e-04 +
      z * (2.75573137070700676789e-06 + z * (-2.50507602534068634195e-08 +
      z * 1.58969099521155010221e-10)))));
  const double co = (1.0 - 0.5 * z) + (z * z) * (4.16666666666666019037e-02 +
      z * (-1.38888888888741095749e-03 + z * (2.48015872894767294178e-05 +
      z * (-2.75573143513906633035e-07 + z * (2.08757232129817482790e-09 +
      z * -1.13596475577881948265e-11)))));
  const int q = static_cast<int>(static_cast<long long>(k) & 3);
  const double out = q == 0 ? s : q == 1 ? co : q == 2 ? -s : -co;
  return static_cast<float>(out);
}

// --------------------------------------------------- workload draws ----
// Each draw is uniform(fold_in(counter_key(stream_key(seed, S), core),
// index)): the per-core key is folded once a launch, so a draw costs two
// threefry blocks.

__device__ __forceinline__ float draw(uint32_t k0, uint32_t k1, int ix) {
  uint32_t x0 = 0, x1 = static_cast<uint32_t>(ix);
  threefry2x32(k0, k1, x0, x1);
  return uniform01(x0, x1);
}

// `core`'s key of one stream, from its lane (every lane calls this).
__device__ __forceinline__ float draw_of(uint32_t k0, uint32_t k1, int core,
                                         int ix) {
  return draw(__shfl_sync(kFull, k0, core), __shfl_sync(kFull, k1, core), ix);
}

// counter_key(stream_key(seed, stream), core).
__device__ __forceinline__ void core_key(uint32_t seed, uint32_t stream,
                                         int core, uint32_t& k0,
                                         uint32_t& k1) {
  uint32_t a = 0, b = stream;
  threefry2x32(0u, seed, a, b);
  k0 = 0;
  k1 = static_cast<uint32_t>(core);
  threefry2x32(a, b, k0, k1);
}

__device__ __forceinline__ float exp_unit(float u) { return -xla_log1p(-u); }

// jax.random.normal from its uniform: max(lo, f * 2 + lo), sqrt(2) erf_inv.
__device__ __forceinline__ float normal_of(float f) {
  const float lo = bits_f(0xBF7FFFFFu);
  return xla_erf_inv(fmaxf(f * 2.0f + lo, lo)) * bits_f(0x3FB504F3u);
}

__device__ __forceinline__ float service_unit(float u, float z, int dist,
                                              const Cell& c) {
  if (dist == 1) return exp_unit(u);
  if (dist == 2) {  // lognormal, mean 1, cv
    const float s2 = xla_log1p(c.wl_cv * c.wl_cv);
    return xla_exp(fmaf(sqrtf(s2), z, -(0.5f * s2)));
  }
  if (dist == 3) {  // bimodal Get/Put mix
    const float short_mode =
        1.0f / fmaf(c.wl_mix, c.wl_mix_scale, 1.0f - c.wl_mix);
    return u < c.wl_mix ? short_mode * c.wl_mix_scale : short_mode;
  }
  return 1.0f;
}

__device__ __forceinline__ int phase_flip(float u, int on, const Cell& c) {
  return u < 1.0f / fmaxf(c.wl_burst_len, 1.0f) ? 1 - on : on;
}

// The diurnal cycle position of tick t.
__device__ __forceinline__ float phase01(const Cell& c, int t) {
  return fmodf(static_cast<float>(t) / fmaxf(c.wl_period, 1.0f), 1.0f);
}

__device__ __forceinline__ float think_gap(float u, int on, float p01,
                                           const Cell& c) {
  const float rate = c.wl_rate;
  const float e1 = exp_unit(u);
  if (c.wl_process == 1) return e1 / rate;
  if (c.wl_process == 2) {  // MMPP: on = burstiness x off
    const float b = c.wl_burst;
    const float r_off = rate * (1.0f + b) / (2.0f * b);
    return e1 / (on == 1 ? b * r_off : r_off);
  }
  if (c.wl_process == 3) {  // diurnal ramp, floored at 5 % of the mean
    const float mod = fmaf(c.wl_amp, sin_f32(bits_f(0x40C90FDBu) * p01), 1.0f);
    return e1 / fmaxf(rate * mod, 0.05f * rate);
  }
  return 1.0f / rate;
}

// ------------------------------------------------- glibc's powf ----
// XLA's CPU code calls glibc's powf for an f32 x ** y; this is that
// function (sysdeps/ieee754/flt-32/e_powf.c as its x86-64 FMA variant
// runs it, repro_torch/core/xla_math.py::powf): log2(x) through a
// 16-entry table and a polynomial in double, times y, exp2 through a
// 32-entry table and a polynomial in double, rounded once to f32, with
// its nine FMAs as __fma_rn and every other double operation rounded;
// subnormal results flushed to zero, as under XLA's runtime.

// (1/c, log2 c) of each subinterval of [0x3f330000, 2 x that).
__constant__ double kPowfTab[32] = {
    0x1.661ec79f8f3bep+0, -0x1.efec65b963019p-2, 0x1.571ed4aaf883dp+0,
    -0x1.b0b6832d4fca4p-2, 0x1.49539f0f010b0p+0, -0x1.7418b0a1fb77bp-2,
    0x1.3c995b0b80385p+0, -0x1.39de91a6dcf7bp-2, 0x1.30d190c8864a5p+0,
    -0x1.01d9bf3f2b631p-2, 0x1.25e227b0b8ea0p+0, -0x1.97c1d1b3b7af0p-3,
    0x1.1bb4a4a1a343fp+0, -0x1.2f9e393af3c9fp-3, 0x1.12358f08ae5bap+0,
    -0x1.960cbbf788d5cp-4, 0x1.0953f419900a7p+0, -0x1.a6f9db6475fcep-5,
    0x1.0000000000000p+0, 0x0.0p+0, 0x1.e608cfd9a47acp-1,
    0x1.338ca9f24f53dp-4, 0x1.ca4b31f026aa0p-1, 0x1.476a9543891bap-3,
    0x1.b2036576afce6p-1, 0x1.e840b4ac4e4d2p-3, 0x1.9c2d163a1aa2dp-1,
    0x1.40645f0c6651cp-2, 0x1.886e6037841edp-1, 0x1.88e9c2c1b9ff8p-2,
    0x1.767dcf5534862p-1, 0x1.ce0a44eb17bccp-2};
// exp2's table: the bits of 2^(j/32), less j << 47.
__constant__ unsigned long long kExp2fT[32] = {
    0x3ff0000000000000ull, 0x3fefd9b0d3158574ull, 0x3fefb5586cf9890full,
    0x3fef9301d0125b51ull, 0x3fef72b83c7d517bull, 0x3fef54873168b9aaull,
    0x3fef387a6e756238ull, 0x3fef1e9df51fdee1ull, 0x3fef06fe0a31b715ull,
    0x3feef1a7373aa9cbull, 0x3feedea64c123422ull, 0x3feece086061892dull,
    0x3feebfdad5362a27ull, 0x3feeb42b569d4f82ull, 0x3feeab07dd485429ull,
    0x3feea47eb03a5585ull, 0x3feea09e667f3bcdull, 0x3fee9f75e8ec5f74ull,
    0x3feea11473eb0187ull, 0x3feea589994cce13ull, 0x3feeace5422aa0dbull,
    0x3feeb737b0cdc5e5ull, 0x3feec49182a3f090ull, 0x3feed503b23e255dull,
    0x3feee89f995ad3adull, 0x3feeff76f2fb5e47ull, 0x3fef199bdd85529cull,
    0x3fef3720dcef9069ull, 0x3fef5818dcfba487ull, 0x3fef7c97337b9b5full,
    0x3fefa4afa2a490daull, 0x3fefd0765b6e4540ull};

__device__ __forceinline__ bool zeroinfnan(uint32_t i) {
  return 2u * i - 1u >= 2u * 0x7f800000u - 1u;
}

__device__ __forceinline__ bool is_signaling(float x) {
  return 2u * (__float_as_uint(x) ^ 0x00400000u) > 2u * 0x7fc00000u;
}

// 0: y is not an integer, 1: an odd integer, 2: an even one.
__device__ __forceinline__ int checkint(uint32_t iy) {
  const int e = (iy >> 23) & 0xff;
  if (e < 0x7f) return 0;
  if (e > 0x7f + 23) return 2;
  if (iy & ((1u << (0x7f + 23 - e)) - 1u)) return 0;
  if (iy & (1u << (0x7f + 23 - e))) return 1;
  return 2;
}

__device__ __forceinline__ float xla_powf(float x, float y) {
  uint32_t ix = __float_as_uint(x);
  const uint32_t iy = __float_as_uint(y);
  bool negate = false;
  if (ix - 0x00800000u >= 0x7f800000u - 0x00800000u || zeroinfnan(iy)) {
    if (zeroinfnan(iy)) {
      if (2u * iy == 0u) return is_signaling(x) ? x + y : 1.0f;
      if (ix == 0x3f800000u) return is_signaling(y) ? x + y : 1.0f;
      if (2u * ix > 2u * 0x7f800000u || 2u * iy > 2u * 0x7f800000u)
        return x + y;
      if (2u * ix == 2u * 0x3f800000u) return 1.0f;
      if ((2u * ix < 2u * 0x3f800000u) == !(iy & 0x80000000u)) return 0.0f;
      return __fmul_rn(y, y);
    }
    if (zeroinfnan(ix)) {
      float x2 = __fmul_rn(x, x);
      if ((ix & 0x80000000u) && checkint(iy) == 1) x2 = -x2;
      return (iy & 0x80000000u) ? __fdiv_rn(1.0f, x2) : x2;
    }
    if (ix & 0x80000000u) {  // finite x < 0
      const int yint = checkint(iy);
      if (yint == 0) return __int_as_float(0x7fc00000);
      negate = yint == 1;
      ix &= 0x7fffffffu;
    }
    if (ix < 0x00800000u) {  // subnormal x: normalised
      ix = __float_as_uint(__fmul_rn(x, 0x1p23f)) & 0x7fffffffu;
      ix -= 23u << 23;
    }
  }
  // log2(x) = log1p(z / c - 1) / ln 2 + log2(c) + k, x = 2^k z.
  const uint32_t tmp = ix - 0x3f330000u;
  const int i = (tmp >> 19) & 15;
  const uint32_t top = tmp & 0xff800000u;
  const int k = static_cast<int32_t>(top) >> 23;
  const double z = static_cast<double>(__uint_as_float(ix - top));
  const double r = __fma_rn(z, kPowfTab[2 * i], -1.0);
  const double y0 = __dadd_rn(kPowfTab[2 * i + 1], static_cast<double>(k));
  const double r2 = __dmul_rn(r, r);
  const double p1 = __fma_rn(r, 0x1.27616c9496e0bp-2, -0x1.71969a075c67ap-2);
  const double p2 = __fma_rn(r, 0x1.ec70a6ca7baddp-2, -0x1.7154748bef6c8p-1);
  const double r4 = __dmul_rn(r2, r2);
  double q = __fma_rn(r, 0x1.71547652ab82bp+0, y0);
  q = __fma_rn(r2, p2, q);
  const double ylogx = __dmul_rn(static_cast<double>(y), __fma_rn(p1, r4, q));
  float out;
  if (ylogx > 0x1.fffffffd1d571p+6) {
    out = __int_as_float(0x7f800000);
  } else if (ylogx <= -150.0) {
    out = 0.0f;
  } else {
    // exp2(ylogx) = 2^(k/32) 2^r, r in [-1/64, 1/64].
    const double shift = 0x1.8p+47;
    const double kd = __dadd_rn(ylogx, shift);
    const long long kk =
        __double_as_longlong(kd) - __double_as_longlong(shift);
    const double rr = __dsub_rn(ylogx, __dsub_rn(kd, shift));
    const double s = __longlong_as_double(static_cast<long long>(
        kExp2fT[kk & 31] + (static_cast<unsigned long long>(kk) << 47)));
    const double zz = __fma_rn(rr, 0x1.c6af84b912394p-5, 0x1.ebfce50fac4f3p-3);
    const double yy = __fma_rn(rr, 0x1.62e42ff0c52d6p-1, 1.0);
    out = __double2float_rn(
        __dmul_rn(__fma_rn(zz, __dmul_rn(rr, rr), yy), s));
    if (fabsf(out) < bits_f(0x00800000u)) out = 0.0f;  // flush to zero
  }
  return negate ? -out : out;
}

// ------------------------------------------------ key-sharded draws ----

// The lock of a key drawn from uniform u under the cell's Zipf constants:
// the Gray / YCSB inverse CDF in the compiled reference's f32 operations
// (eta u - eta one FMA), clipped, then the key's bucket.
__device__ __forceinline__ float kp_f(const Cell& c, int k) {
  return __int_as_float(c.kp[k]);
}

__device__ __forceinline__ int zipf_lock(const Cell& c, float u) {
  const float n = static_cast<float>(c.kp[kpKeys]);
  const float eta = kp_f(c, kpEta);
  const float uz = __fmul_rn(u, kp_f(c, kpZeta));
  const float base = __fadd_rn(fmaf(eta, u, -eta), 1.0f);
  const float tail = floorf(__fmul_rn(n, xla_powf(base, kp_f(c, kpAlpha))));
  const float k = uz < 1.0f ? 0.0f : uz < kp_f(c, kpZeta2) ? 1.0f : tail;
  // fmaxf takes NaN to 0, as XLA's conversion does.
  const int key = static_cast<int>(fminf(fmaxf(k, 0.0f), __fsub_rn(n, 1.0f)));
  return key % max(c.kp[kpLocks], 1);
}

// Core `core`'s epoch `ep`: its lock, and its read/write uniform where the
// cell's policy reads it, each from the core's staged stream key (every
// lane draws the same value).
__device__ __forceinline__ void key_draws(Cell& c, int core, int ep) {
  c.lk[core] = zipf_lock(c, draw(c.kkey[2 * core], c.kkey[2 * core + 1],
                                 ep));
  if (c.rw)
    c.cur_rw[core] = draw(c.rwkey[2 * core], c.rwkey[2 * core + 1], ep);
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

// Make `core` the holder of its segment's lock; schedule its release,
// in the reference's order: the critical section scaled by the epoch's
// service draw (wl; at least one tick), plus a straggler spike and a
// preemption stall (drawn by the core's critical-section count, the
// rates times its ft_mask), plus the wakeup of a queue-pop handoff
// (`handoff`) when that gate is on.
__device__ __forceinline__ void grant(Cell& c, int core, int t,
                                      bool handoff = false) {
  c.holder[c.lk[core]] = core;
  c.phase[core] = kHolder;
  int dur = c.cs_dur[core * c.s + c.seg[core]];
  if (c.wl)
    dur = max(static_cast<int>(static_cast<float>(dur) * c.svc_scale[core]),
              1);
  if (c.straggle || c.preempt) {
    const int gix = c.cs_cnt[core];
    const float elig = c.ft_mask[core];
    if (c.straggle) {
      const float u = draw_of(c.sp0, c.sp1, core, gix);
      const int extra = static_cast<int>(static_cast<float>(dur) *
                                         (c.straggle_scale - 1.0f));
      if (u < c.straggle_rate * elig) dur += extra;
    }
    if (c.preempt) {
      const float u = draw_of(c.pr0, c.pr1, core, gix);
      const float uz = draw_of(c.pz0, c.pz1, core, gix);
      const int stall = static_cast<int>(c.preempt_scale * exp_unit(uz));
      if (u < c.preempt_rate * elig) dur += stall;
    }
  }
  set_ready(c, core, t + (handoff ? dur + c.wakeup : dur));
}

// One latency sample into `core`'s log-bucketed histogram row (device
// memory, lane 0): 1 + floor((log2(max(v, 1e-6)) - log2_lo) * inv_log2g),
// clipped, the log2's multiply fused into the subtraction as the
// compiled reference does it.
__device__ __forceinline__ void hist_record(const Cell& c, int* h, int core,
                                            float v) {
  const float lg = fmaf(xla_log(fmaxf(v, 1e-6f)), bits_f(0x3FB8AA3Bu),
                        -c.log2_lo) * c.inv_log2g;
  const int idx = min(max(1 + static_cast<int>(floorf(lg)), 0), c.hb - 1);
  if (c.lane == 0) h[core * c.hb + idx] += 1;
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

// The owner of lock l (ks_erew, ks_crew): the position l mod n_active in
// the stable order active big cores, active little cores, the rest (lane
// 0 when no core is active).  Every lane reaches each ballot.
__device__ __forceinline__ int owner_of(const Cell& c, int l) {
  const int j = c.lane;
  const int n_active = c.kp[kpNActive];
  const bool act = j < n_active;
  const bool big = act && c.big[j] == 1;
  const unsigned bigs = __ballot_sync(kFull, big);
  const unsigned lits = __ballot_sync(kFull, act && !big);
  const unsigned below = (1u << j) - 1u;
  const int pos = big ? __popc(bigs & below)
                      : __popc(bigs) + __popc(lits & below);
  const unsigned at =
      __ballot_sync(kFull, act && pos == l % max(n_active, 1));
  return at ? __ffs(at) - 1 : 0;
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
  } else if (P == kKsErew) {
    // The lock's owner jumps the FIFO head, at most erew_bound in a row.
    const bool wt = waiting(c, l);
    const int head = first_min(wt ? c.attempt_t[j] : kInf);
    const int owner = owner_of(c, l);
    const bool use = c.phase[owner] == kQueued && c.lk[owner] == l &&
                     c.erew_ctr[l] < c.kp[kpErewBound];
    bounded_grant(c, c.erew_ctr, l, use ? owner : head, head, t);
  } else if (P == kKsCrew) {
    // The earliest reader; else the owner's write; at most crew_bound
    // bypasses of the FIFO head in a row.
    const bool wt = waiting(c, l);
    const float wfrac = kp_f(c, kpCrewWfrac);
    const bool reader = wt && !(c.cur_rw[j] < wfrac);
    const int head = first_min(wt ? c.attempt_t[j] : kInf);
    const int r_head = first_min(reader ? c.attempt_t[j] : kInf);
    const bool any_r = __any_sync(kFull, reader);
    const int owner = owner_of(c, l);
    const bool owner_writes = c.phase[owner] == kQueued &&
                              c.lk[owner] == l &&
                              c.cur_rw[owner] < wfrac;
    const bool use =
        (any_r || owner_writes) && c.crew_ctr[l] < c.kp[kpCrewBound];
    const int prefer = any_r ? r_head : owner_writes ? owner : 0;
    bounded_grant(c, c.crew_ctr, l, use ? prefer : head, head, t);
  } else if (P == kKsJbsq) {
    // The least served waiter (fewest epochs, then the earliest attempt);
    // the FIFO head once jbsq_k grants in a row bypassed it.
    const bool wt = waiting(c, l);
    const int head = first_min(wt ? c.attempt_t[j] : kInf);
    const int least_ep = __reduce_min_sync(kFull, wt ? c.ep_cnt[j] : kInf);
    const int least = first_min(wt && c.ep_cnt[j] == least_ep
                                    ? c.attempt_t[j] : kInf);
    const bool use = __any_sync(kFull, wt) && c.jbsq_ctr[l] < c.kp[kpJbsqK];
    bounded_grant(c, c.jbsq_ctr, l, use ? least : head, head, t);
  }
}

// Run hook `F<policy>` of the cell's policy: the instantiation's own, or,
// in the merged instantiation, the one the cell's id names (uniform over
// the warp: a warp is one cell); the ks_* members only where the
// instantiation takes ArgsK (KA).
#define BY_POLICY(P, KA, F, ...)                               \
  do {                                                         \
    if constexpr (P == kMerged) {                              \
      switch (c.pol) {                                         \
        case kFifo: F<kFifo>(__VA_ARGS__); break;              \
        case kTas: F<kTas>(__VA_ARGS__); break;                \
        case kProp: F<kProp>(__VA_ARGS__); break;              \
        case kLibasl: F<kLibasl>(__VA_ARGS__); break;          \
        case kEdf: F<kEdf>(__VA_ARGS__); break;                \
        case kShfl: F<kShfl>(__VA_ARGS__); break;              \
        default:                                               \
          if constexpr (KA) {                                  \
            if (c.pol == kKsErew)                              \
              F<kKsErew>(__VA_ARGS__);                         \
            else if (c.pol == kKsCrew)                         \
              F<kKsCrew>(__VA_ARGS__);                         \
            else if (c.pol == kKsJbsq)                         \
              F<kKsJbsq>(__VA_ARGS__);                         \
            else                                               \
              F<kDvfsRace>(__VA_ARGS__);                       \
          } else {                                             \
            F<kDvfsRace>(__VA_ARGS__);                         \
          }                                                    \
          break;                                               \
      }                                                        \
    } else {                                                   \
      F<P>(__VA_ARGS__);                                       \
    }                                                          \
  } while (0)

// A duration of the next epoch's program under its scale (the long-epoch
// and closed-loop think draws; int(float(d) * scale), truncated);
// unscaled when neither is on.
__device__ __forceinline__ int scaled(bool on, int d, float scale) {
  return on ? static_cast<int>(__fmul_rn(static_cast<float>(d), scale)) : d;
}

// Release: the latency records (and the histograms), libasl's AIMD, the
// next epoch's workload, the next segment, and the policy's pick of the
// next holder.  Outside the stochastic instantiations the wl / open /
// hist gates are constant false and their paths compile away.
template <int P, bool KA, bool KS>
__device__ __forceinline__ void release(Cell& c, int core, int t) {
  const int s = c.seg[core];
  const int l = c.lk[core];
  // The histograms count a sample whose index (the count before it) is
  // past the warmup.
  const float cs_latency = static_cast<float>(t - c.attempt_t[core]);
  if (c.hist && c.cs_cnt[core] >= c.hist_warmup)
    hist_record(c, c.cs_hist, core, cs_latency);
  record(c, c.cs_lat, c.cs_cnt, core, cs_latency);
  const bool last = s == c.s - 1;
  const float ep_latency = static_cast<float>(t - c.epoch_start[core]);
  if (last) {
    if (c.hist && c.ep_cnt[core] >= c.hist_warmup)
      hist_record(c, c.ep_hist, core, ep_latency);
    record(c, c.ep_lat, c.ep_cnt, core, ep_latency);
  }
  const bool libasl = P == kLibasl || (P == kMerged && c.pol == kLibasl);
  if (libasl && last && c.big[core] == 0) aimd(c, core, ep_latency);
  // The next epoch's workload.  Long epochs: every release splits the
  // key; an epoch end draws the scale of its non-critical work.  wl: the
  // draws by (core, the next epoch's index) set its service scale and,
  // closed loop, its think scale and MMPP phase.
  float scale = c.scaled ? c.scale[core] : 1.0f;
  if (c.long_on) {
    uint32_t s0, s1;
    advance_key(c, s0, s1);
    if (last) {
      scale = uniform01(s0, s1) < c.long_prob ? c.long_scale : 1.0f;
      c.scale[core] = scale;
    }
  }
  if (c.wl && last) {
    const int ep = c.ep_cnt[core];
    const float u_s = draw_of(c.sv0, c.sv1, core, ep);
    const float z_s = normal_of(draw_of(c.sz0, c.sz1, core, ep));
    const int dist = c.wl_service[core];
    c.svc_scale[core] =
        service_unit(u_s, z_s, dist >= 0 ? dist : c.wl_service_cell, c);
    if (!c.open) {
      const float u_t = draw_of(c.th0, c.th1, core, ep);
      const float u_p = draw_of(c.ph0, c.ph1, core, ep);
      const int on = phase_flip(u_p, c.wl_on[core], c);
      const float think = think_gap(u_t, on, phase01(c, t), c);
      scale = c.long_on ? __fmul_rn(scale, think) : think;
      c.scale[core] = scale;
      c.wl_on[core] = on;
    }
  }
  const int inter = scaled(c.scaled, c.inter[core], scale);
  if (last) {
    c.seg[core] = 0;
    if constexpr (KS) {
      // Keyed: the closed loop draws the next epoch's lock (ep_cnt counts
      // it now; the old lock l is read above), the open loop at its
      // arrival.
      if (!c.ks)
        c.lk[core] = c.seg_lock[0];
      else if (!c.open)
        key_draws(c, core, c.ep_cnt[core]);
    } else {
      c.lk[core] = c.seg_lock[0];
    }
    if (c.open) {
      // Open loop: park on the pending arrival (possibly already past).
      set_ready(c, core, max(t, c.arr_t[core]));
    } else {
      c.epoch_start[core] = t + inter;
      set_ready(c, core,
                t + inter + scaled(c.scaled, c.nc_dur[core * c.s], scale));
    }
  } else {
    c.seg[core] = s + 1;
    if constexpr (KS) {
      if (!c.ks) c.lk[core] = c.seg_lock[s + 1];
    } else {
      c.lk[core] = c.seg_lock[s + 1];
    }
    set_ready(c, core, t + scaled(c.scaled,
                                  c.nc_dur[core * c.s + min(s + 1, c.s - 1)],
                                  scale));
  }
  c.phase[core] = last && c.open ? kArrival : kNonCrit;
  c.holder[l] = -1;
  BY_POLICY(P, KA, pick_next, c, l, t);
}

// Open loop: the pending arrival fired.  The epoch begins at its true
// arrival time (in the past when the core is backlogged), and the next
// arrival's gap is drawn (index: the arrivals so far + 1).
template <bool KS>
__device__ __forceinline__ void arrival(Cell& c, int core, int t) {
  const int a = c.arr_t[core];
  const int ix = c.ep_cnt[core] + 1;
  const float u_t = draw_of(c.th0, c.th1, core, ix);
  const float u_p = draw_of(c.ph0, c.ph1, core, ix);
  const int on = phase_flip(u_p, c.wl_on[core], c);
  const float gap = think_gap(u_t, on, phase01(c, t), c);
  const int nc = c.nc_dur[core * c.s];
  const float base = static_cast<float>(c.inter[core] + nc);
  c.arr_t[core] = a + max(static_cast<int>(base * gap), 1);
  c.wl_on[core] = on;
  c.epoch_start[core] = a;
  c.phase[core] = kNonCrit;
  set_ready(c, core,
            t + static_cast<int>(static_cast<float>(nc) * c.scale[core]));
  if constexpr (KS) {
    // Keyed: the epoch this arrival begins (index ep_cnt) draws its lock.
    if (c.ks) key_draws(c, core, c.ep_cnt[core]);
  }
}

// One event of one cell (the caller checked that the cell is live).
// KA: the instantiation takes ArgsK; KS: it compiles the key draws
// (stochastic, with ArgsK).
template <int P, bool KA, bool KS>
__device__ __forceinline__ void step(Cell& c, int core, int t) {
  const int ph = c.phase[core];
  if (ph == kNonCrit) {
    if (c.churn) {
      // Core churn: an attempt in an "off" slot bounces to the next slot
      // boundary; the policy never sees it.
      const int slot = t / c.churn_period;
      if (draw_of(c.ch0, c.ch1, core, slot) < c.churn_rate * c.ft_mask[core]) {
        set_ready(c, core, (slot + 1) * c.churn_period);
        return;
      }
    }
    c.attempt_t[core] = t;
    BY_POLICY(P, KA, acquire, c, core, t);
  } else if (ph == kHolder) {
    release<P, KA, KS>(c, core, t);
  } else if (ph == kStandby) {
    if (P == kLibasl || (P == kMerged && c.pol == kLibasl))
      standby_expiry(c, core, t);
  } else if (ph == kQueued || ph == kSpin) {
    set_ready(c, core, kInf);  // defensive re-park
  } else if (ph == kArrival) {
    if (c.open) arrival<KS>(c, core, t);
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

// A keyed operand's pointer, or null where the launch does not pass it.
template <typename T>
__device__ __forceinline__ T* key_at(const ArgsK& a, KeyOperand k,
                                     size_t offset) {
  return a.k[k] ? static_cast<T*>(a.k[k]) + offset : nullptr;
}

// Words of one cell's stage: an ArgsK instantiation's are keyed_words
// longer.
template <bool ST, bool KA>
__host__ __device__ constexpr int stage_words(int n, int s, int l) {
  if constexpr (KA)
    return cell_words(n, s, l, ST) + keyed_words(n, l);
  else
    return cell_words(n, s, l, ST);
}

__device__ __forceinline__ bool key_gate(const Args&) { return false; }
__device__ __forceinline__ bool key_gate(const ArgsK& a) {
  return a.ks_on != 0;
}

// One launch of one cell (a warp).  P: the policy (kMerged: each cell's).
// ST: the stochastic instantiation, which stages and runs the wl /
// wl_open / hist / fault / key paths under their gates; the others compile
// none of them.  A: Args, or ArgsK with the keyed operands (KA: a keyed
// launch's instantiations), which stages cur_rw, the ks_* counters and the
// keyed params; the key gate needs ST and KA.
template <int P, bool ST, typename A>
__device__ __forceinline__ void run_chunk(const A& a, int warps_per_block) {
  constexpr bool KA = std::is_same<A, ArgsK>::value;
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
      __cvta_generic_to_shared(smem + w * stage_words<ST, KA>(n, s, l)));
  asm volatile("" : "+r"(stage));
  Cell c;
  carve(c, static_cast<int*>(__cvta_shared_to_generic(stage)), n, s, l, ST);
  if constexpr (KA) {
    carve_keyed(c, static_cast<int*>(__cvta_shared_to_generic(stage)) +
                       cell_words(n, s, l, ST), n, l);
  }
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
  // The stochastic gates: constant false outside ST, so the paths they
  // guard compile away.
  c.wl = ST && a.wl_on != 0;
  c.open = ST && a.open_on != 0;
  c.hist = ST && a.hist_on != 0;
  c.preempt = ST && a.preempt_on != 0;
  c.churn = ST && a.churn_on != 0;
  c.straggle = ST && a.straggle_on != 0;
  c.scaled = c.long_on || (c.wl && !c.open);
  c.slo = *at<float>(a, kSlo, cb);
  c.pol = P == kMerged ? *at<int>(a, kPolId, cb) : P;
  if constexpr (KA) {
    // Keyed traffic: the draws (ST only) and, where the cell's policy is
    // ks_crew, the read/write uniform.
    c.ks = ST && key_gate(a);
    c.rw = c.ks && (P == kKsCrew || (P == kMerged && c.pol == kKsCrew));
  }
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
  if (ST) {
    // The cell's params of the gated features, and this lane's core's
    // key of each stream they draw from.
    const uint32_t seed =
        (c.wl || c.preempt || c.churn || c.straggle)
            ? static_cast<uint32_t>(*at<int>(a, kSeed, cb)) : 0u;
    const int core = lane;
    if (c.wl) {
      c.wl_process = *at<int>(a, kWlProcess, cb);
      c.wl_service_cell = *at<int>(a, kWlService, cb);
      c.wl_rate = *at<float>(a, kWlRate, cb);
      c.wl_cv = *at<float>(a, kWlCv, cb);
      c.wl_mix = *at<float>(a, kWlMix, cb);
      c.wl_mix_scale = *at<float>(a, kWlMixScale, cb);
      c.wl_burst = *at<float>(a, kWlBurst, cb);
      c.wl_burst_len = *at<float>(a, kWlBurstLen, cb);
      c.wl_amp = *at<float>(a, kWlAmp, cb);
      c.wl_period = *at<float>(a, kWlPeriod, cb);
      core_key(seed, 0x7781u, core, c.th0, c.th1);
      core_key(seed, 0x7782u, core, c.sv0, c.sv1);
      core_key(seed, 0x7782u ^ 0x40000u, core, c.sz0, c.sz1);
      core_key(seed, 0x7783u, core, c.ph0, c.ph1);
    }
    if (c.preempt) {
      c.preempt_rate = *at<float>(a, kPreemptRate, cb);
      c.preempt_scale = *at<float>(a, kPreemptScale, cb);
      core_key(seed, 0x7787u, core, c.pr0, c.pr1);
      core_key(seed, 0x7787u ^ 0x40000u, core, c.pz0, c.pz1);
    }
    if (c.churn) {
      c.churn_rate = *at<float>(a, kChurnRate, cb);
      c.churn_period = *at<int>(a, kChurnPeriod, cb);
      core_key(seed, 0x7788u, core, c.ch0, c.ch1);
    }
    if (c.straggle) {
      c.straggle_rate = *at<float>(a, kStraggleRate, cb);
      c.straggle_scale = *at<float>(a, kStraggleScale, cb);
      core_key(seed, 0x7789u, core, c.sp0, c.sp1);
    }
    if (c.hist) {
      c.hb = a.hist_buckets;
      c.hist_warmup = *at<int>(a, kHistWarmup, cb);
      c.log2_lo = *at<float>(a, kHistLog2Lo, cb);
      c.inv_log2g = *at<float>(a, kHistInvLog2g, cb);
      c.ep_hist = at<int>(a, kEpHist, cb * n * a.hist_buckets);
      c.cs_hist = at<int>(a, kCsHist, cb * n * a.hist_buckets);
    }
    if constexpr (KA) {
      if (c.ks) {
        // The cell's Zipf constants, and this lane's core's stream keys,
        // staged.
        c.kp[kpKeys] = *key_at<int>(a, kKsKeys, cb);
        c.kp[kpLocks] = *key_at<int>(a, kKsLocks, cb);
        c.kp[kpZeta] = *key_at<int>(a, kKsZeta, cb);
        c.kp[kpEta] = *key_at<int>(a, kKsEta, cb);
        c.kp[kpAlpha] = *key_at<int>(a, kKsAlpha, cb);
        c.kp[kpZeta2] = __float_as_int(__fadd_rn(
            1.0f, xla_powf(0.5f, *key_at<float>(a, kKsTheta, cb))));
        const uint32_t kseed = static_cast<uint32_t>(*at<int>(a, kSeed, cb));
        uint32_t k0, k1;
        core_key(kseed, 0x778Au, core, k0, k1);
        if (lane < n) {
          c.kkey[2 * lane] = k0;
          c.kkey[2 * lane + 1] = k1;
        }
        if (c.rw) {
          core_key(kseed, 0x778Bu, core, k0, k1);
          if (lane < n) {
            c.rwkey[2 * lane] = k0;
            c.rwkey[2 * lane + 1] = k1;
          }
        }
      }
    }
  }
  // The ks_* policies' knobs and their owners' active core count, staged.
  if constexpr (KA) {
    const int* g_n_active = at_opt<int>(a, kNActive, cb);
    const int* g_erew_bound = key_at<int>(a, kErewBound, cb);
    const int* g_crew_wfrac = key_at<int>(a, kCrewWfrac, cb);
    const int* g_crew_bound = key_at<int>(a, kCrewBound, cb);
    const int* g_jbsq_k = key_at<int>(a, kJbsqK, cb);
    c.kp[kpNActive] = g_n_active ? *g_n_active : n;
    c.kp[kpErewBound] = g_erew_bound ? *g_erew_bound : 0;
    c.kp[kpCrewWfrac] = g_crew_wfrac ? *g_crew_wfrac : 0;
    c.kp[kpCrewBound] = g_crew_bound ? *g_crew_bound : 0;
    c.kp[kpJbsqK] = g_jbsq_k ? *g_jbsq_k : 0;
  }

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
    const float scale =
        c.long_on || c.wl ? at<float>(a, kScale, cn)[lane] : 1.0f;
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
    if (ST) {
      c.svc_scale[lane] = c.wl ? at<float>(a, kSvcScale, cn)[lane] : 1.0f;
      c.wl_on[lane] = c.wl ? at<int>(a, kWlOn, cn)[lane] : 0;
      c.arr_t[lane] = c.open ? at<int>(a, kArrT, cn)[lane] : 0;
      c.wl_service[lane] = c.wl ? at<int>(a, kWlServiceCol, cn)[lane] : -1;
      c.ft_mask[lane] = c.preempt || c.churn || c.straggle
                            ? at<float>(a, kFtMask, cn)[lane] : 1.0f;
    }
    if constexpr (KA) {
      const float* g_cur_rw = key_at<float>(a, kCurRw, cn);
      c.cur_rw[lane] = g_cur_rw ? g_cur_rw[lane] : 1.0f;
    }
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
  if constexpr (KA) {
    const int* g_erew_ctr = key_at<int>(a, kErewCtr, cl);
    const int* g_crew_ctr = key_at<int>(a, kCrewCtr, cl);
    const int* g_jbsq_ctr = key_at<int>(a, kJbsqCtr, cl);
#pragma unroll 1
    for (int i = lane; i < l; i += 32) {
      const int ec = g_erew_ctr ? g_erew_ctr[i] : 0;
      const int cc = g_crew_ctr ? g_crew_ctr[i] : 0;
      const int jc = g_jbsq_ctr ? g_jbsq_ctr[i] : 0;
      c.erew_ctr[i] = ec;
      c.crew_ctr[i] = cc;
      c.jbsq_ctr[i] = jc;
    }
  }
  __syncwarp();
  // Each core's lock: its epoch's drawn lock when keyed, else its
  // segment's.
  if constexpr (KA) {
    if (lane < n)
      c.lk[lane] = c.ks ? key_at<int>(a, kCurLock, cn)[lane]
                        : c.seg_lock[c.seg[lane]];
  } else {
    if (lane < n) c.lk[lane] = c.seg_lock[c.seg[lane]];
  }
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
    step<P, KA, ST && KA>(c, core, t);
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
  if (c.long_on || c.wl)
    warp_copy(at<float>(a, kScale, cn), c.scale, n, lane);
  if (c.wl) {
    warp_copy(at<float>(a, kSvcScale, cn), c.svc_scale, n, lane);
    warp_copy(at<int>(a, kWlOn, cn), c.wl_on, n, lane);
  }
  if (c.open) warp_copy(at<int>(a, kArrT, cn), c.arr_t, n, lane);
  warp_copy(at<int>(a, kQ, cq * n), c.q, 2 * l * n, lane);
  warp_copy(at<int>(a, kQHead, cq), c.q_head, 2 * l, lane);
  warp_copy(at<int>(a, kQTail, cq), c.q_tail, 2 * l, lane);
  warp_copy(at<int>(a, kHolderOp, cl), c.holder, l, lane);
  warp_copy(at<int>(a, kPropCtr, cl), c.prop_ctr, l, lane);
  if (g_shfl_ctr) warp_copy(g_shfl_ctr, c.shfl_ctr, l, lane);
  if (g_race_ctr) warp_copy(g_race_ctr, c.race_ctr, l, lane);
  if constexpr (KA) {
    int* g_erew_ctr = key_at<int>(a, kErewCtr, cl);
    int* g_crew_ctr = key_at<int>(a, kCrewCtr, cl);
    int* g_jbsq_ctr = key_at<int>(a, kJbsqCtr, cl);
    if (c.ks) warp_copy(key_at<int>(a, kCurLock, cn), c.lk, n, lane);
    if (c.rw) warp_copy(key_at<float>(a, kCurRw, cn), c.cur_rw, n, lane);
    if (g_erew_ctr) warp_copy(g_erew_ctr, c.erew_ctr, l, lane);
    if (g_crew_ctr) warp_copy(g_crew_ctr, c.crew_ctr, l, lane);
    if (g_jbsq_ctr) warp_copy(g_jbsq_ctr, c.jbsq_ctr, l, lane);
  }
  if (lane == 0) {
    *at<int>(a, kT, cb) = t;
    *at<int>(a, kEvents, cb) = events;
    long long* key = at<long long>(a, kKey, 2 * cb);
    key[0] = static_cast<long long>(c.k0);
    key[1] = static_cast<long long>(c.k1);
  }
}

// The kernels: one for Args, one for ArgsK.  An ArgsK instantiation asks
// for one block per SM, which lets ptxas give the stochastic ones the
// registers the key draws need (at the default it held them at 128 and
// spilled); their grids are small, so occupancy costs nothing.
template <int P, bool ST>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
    fused_chunk_kernel(const Args a, int warps_per_block) {
  run_chunk<P, ST>(a, warps_per_block);
}

template <int P, bool ST>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32, 1)
    fused_chunk_kernel(const ArgsK a, int warps_per_block) {
  run_chunk<P, ST>(a, warps_per_block);
}

template <int P, bool ST, typename A>
int launch(const A& a, cudaStream_t stream) {
  void (*kernel)(const A, int) = fused_chunk_kernel<P, ST>;
  const int bytes =
      4 * stage_words<ST, std::is_same<A, ArgsK>::value>(a.n, a.s, a.l);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = min(kMaxWarpsPerBlock, kSmemLimit / bytes);
  const int smem = warps * bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (a.n_cells + warps - 1) / warps;
  kernel<<<blocks, warps * 32, smem, stream>>>(a, warps);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations this library holds: bit 4 P + 2 ST + K of the mask
// (K: it takes ArgsK).  The build compiles the source once per group of
// instantiations (kernels/build.py, SIMSTEP_GROUPS), each group a library
// of its own and all in parallel; a launch loads its group's.  Without
// the macro every instantiation is compiled.
#ifndef SIMSTEP_BUILT
#define SIMSTEP_BUILT (~0ull)
#endif
constexpr bool built(int p, bool st, bool k) {
  return ((SIMSTEP_BUILT) >> (4 * p + 2 * st + k)) & 1ull;
}

template <int P, bool ST, typename A>
int launch_built(const A& a, cudaStream_t st) {
  if constexpr (built(P, ST, std::is_same<A, ArgsK>::value))
    return launch<P, ST>(a, st);
  else
    return static_cast<int>(cudaErrorInvalidDeviceFunction);
}

// An instantiation takes ArgsK where the launch is keyed (keys on, or a
// ks_* policy in the cell's set): always for the ks_* policies, never for
// the seven others' deterministic ones; the rest have both.
template <int P, bool ST>
int launch_args(const ArgsK& a, bool keyed, cudaStream_t st) {
  if constexpr (P == kKsErew || P == kKsCrew || P == kKsJbsq)
    return launch_built<P, ST>(a, st);
  else if constexpr (!ST && P != kMerged)
    return launch_built<P, ST>(static_cast<const Args&>(a), st);
  else
    return keyed ? launch_built<P, ST>(a, st)
                 : launch_built<P, ST>(static_cast<const Args&>(a), st);
}

template <bool ST>
int launch_policy(int policy, const ArgsK& a, bool keyed, cudaStream_t st) {
  switch (policy) {
    case kFifo:
      return launch_args<kFifo, ST>(a, keyed, st);
    case kTas:
      return launch_args<kTas, ST>(a, keyed, st);
    case kProp:
      return launch_args<kProp, ST>(a, keyed, st);
    case kLibasl:
      return launch_args<kLibasl, ST>(a, keyed, st);
    case kEdf:
      return launch_args<kEdf, ST>(a, keyed, st);
    case kShfl:
      return launch_args<kShfl, ST>(a, keyed, st);
    case kDvfsRace:
      return launch_args<kDvfsRace, ST>(a, keyed, st);
    case kKsErew:
      return launch_args<kKsErew, ST>(a, keyed, st);
    case kKsCrew:
      return launch_args<kKsCrew, ST>(a, keyed, st);
    case kKsJbsq:
      return launch_args<kKsJbsq, ST>(a, keyed, st);
    case -1:
      return launch_args<kMerged, ST>(a, keyed, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Shared memory of one cell, in bytes (`keyed`: an instantiation that
// takes ArgsK): the wrapper raises by name where a shape does not fit one
// block.
int simstep_cell_bytes(int n, int s, int l, int stoch, int keyed) {
  return 4 * (cell_words(n, s, l, stoch != 0) +
              (keyed ? keyed_words(n, l) : 0));
}

// Advance every cell by up to `chunk` events on `stream`.  `operands`
// holds the 88 device pointers (tables, params, state, then the keyed
// operands; the wrapper's _ORDER) into contiguous cell-major tensors, null
// where the launch's gates and policies do not read them; `ints` holds
// n_cells, n, s, l, cap, policy (its id, or -1 for a merged set), chunk,
// max_events, the long-epoch, wakeup and energy gates, then the
// stochastic instantiation (0 / 1), the wl, open-loop and histogram
// gates, the bucket count, the preemption, churn and straggler gates, the
// key gate and whether the launch is keyed (ArgsK: keys on, or a ks_*
// policy in the set); `floats` the AIMD unit factor and the window cap.
// Returns the cudaError_t of the launch (0 = success); the caller raises
// on anything else.
int simstep_fused_chunk(void* const* operands, const int* ints,
                        const float* floats, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ArgsK a;
  for (int k = 0; k < kNumOperands; ++k) a.p[k] = operands[k];
  for (int k = 0; k < kNumKeyOperands; ++k)
    a.k[k] = operands[kNumOperands + k];
  a.ks_on = ints[19];
  const bool keyed = ints[20] != 0;
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
  const bool stoch = ints[11] != 0;
  a.wl_on = ints[12];
  a.open_on = ints[13];
  a.hist_on = ints[14];
  a.hist_buckets = ints[15];
  a.preempt_on = ints[16];
  a.churn_on = ints[17];
  a.straggle_on = ints[18];
  a.unit_mul = floats[0];
  a.max_window = floats[1];
  a.mod_n = fast_mod(static_cast<unsigned>(a.n));
  a.mod_cap = fast_mod(static_cast<unsigned>(a.cap));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return stoch ? launch_policy<true>(ints[5], a, keyed, st)
               : launch_policy<false>(ints[5], a, keyed, st);
}

const char* simstep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
