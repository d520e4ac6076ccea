"""Reproduce the paper's core figures on the PyTorch/CUDA port of the
discrete-event simulator (``repro_torch``); on the card every run goes
through the ``fused_chunk`` kernel.

    PYTHONPATH=src python examples/lock_microbench_torch.py
    PYTHONPATH=src python examples/lock_microbench_torch.py --device cpu

The same sections, columns and defaults as ``examples/lock_microbench.py``
(the JAX package's): the full policy matrix (every policy registered in
``repro_torch.core.policies``), the key-sharded matrix, Figure-1-style
scaling (MCS collapse, TAS latency collapse), the Figure-8b SLO sweep
(LibASL throughput grows with the SLO while the little-core P99 tracks
the SLO line), load-latency and open-loop arrivals.  ``--device``
defaults to the CUDA device (raises without one); ``cpu`` runs the plain
PyTorch version.
"""

import pathlib
import sys

_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT / "src"))

import numpy as np                               # noqa: E402

from repro_torch.core import energy              # noqa: E402
from repro_torch.core import simlock as sl       # noqa: E402
from repro_torch.core.policies import REGISTRY   # noqa: E402

# The fig1 calibration the load labels are derived from
# (benchmarks/paper_figs.py::_cfg): 4 big + 4 little cores, CS 3 us, non-CS
# 1 us, inter-epoch 5 us, little cores 3.75x slower in the CS and 1.8x
# outside it.
_BIG = (1, 1, 1, 1, 0, 0, 0, 0)
_CS = [3.0 * (1.0 if b else 3.75) for b in _BIG]
_THINK = [(1.0 + 5.0) * (1.0 if b else 1.8) for b in _BIG]


def _loadlat_rate(frac: float) -> float:
    """wl_rate that offers ``frac`` of lock capacity: bisect the
    utilization model U(r) = sum_c cs_c / (cs_c + think_c / r)."""
    def util(r):
        return sum(c / (c + th / r) for c, th in zip(_CS, _THINK))

    lo, hi = 1e-4, 1e4
    for _ in range(80):
        mid = (lo * hi) ** 0.5
        if util(mid) < frac:
            lo = mid
        else:
            hi = mid
    return float((lo * hi) ** 0.5)


def _openloop_rate(frac: float) -> float:
    """wl_rate that offers ``frac`` of lock capacity in open-loop mode:
    core ``c`` contributes ``rate / base_c`` arrivals per us (base = its
    closed-loop think budget), each holding the lock for its CS time."""
    return frac / sum(c / b for c, b in zip(_CS, _THINK))


def policy_matrix(slo_us=100.0, sim_time_us=20_000.0, device=None):
    """One row per *registered* lock policy, same 4+4 AMP workload.  The
    energy columns use the calibrated big.LITTLE power tables
    (``repro_torch.core.energy``): J burnt over the run,
    throughput-per-watt and the energy-delay product."""
    print(f"== Policy matrix: {len(REGISTRY)} registered policies "
          f"(SLO {slo_us:.0f}us) ==")
    print(f"{'policy':>8} {'tput':>9} {'little p99':>11} {'big p99':>9} "
          f"{'little share':>13} {'J':>7} {'tput/W':>8} {'EDP':>9}")
    for name in REGISTRY:
        cfg = sl.SimConfig(policy=name, sim_time_us=sim_time_us)
        cfg = sl.with_columns(cfg, **energy.amp_power(cfg.big))
        s = sl.summarize(cfg, sl.run(cfg, slo_us, device=device))
        cs = np.asarray(s["cs_per_core"], float)
        share = cs[4:].sum() / max(cs.sum(), 1.0)
        print(f"{name:>8} {s['throughput_cs_per_s']:>9.0f} "
              f"{s['ep_p99_little_us']:>10.1f}u "
              f"{s['ep_p99_big_us']:>8.1f}u {share:>12.0%} "
              f"{s['energy_j']:>7.4f} {s['tput_per_watt']:>8.0f} "
              f"{s['edp']:>9.2e}")


def figure1(ns=range(1, 9), sim_time_us=40_000.0, device=None):
    print("== Figure 1: scaling 1..8 threads (4 big + 4 little) ==")
    print(f"{'n':>2} {'MCS tput':>10} {'MCS p99':>9} {'TAS tput':>10} "
          f"{'TAS p99':>9}")
    for n in ns:
        big = tuple([1] * min(n, 4) + [0] * max(n - 4, 0))
        kw = dict(n_cores=n, big=big,
                  speed_cs=tuple(1.0 if b else 3.75 for b in big),
                  speed_nc=tuple(1.0 if b else 1.8 for b in big),
                  sim_time_us=sim_time_us)
        mcs_cfg = sl.SimConfig(policy="fifo", **kw)
        mcs = sl.summarize(mcs_cfg, sl.run(mcs_cfg, 1e9, device=device))
        tas_cfg = sl.SimConfig(policy="tas", w_big=0.15, **kw)
        tas = sl.summarize(tas_cfg, sl.run(tas_cfg, 1e9, device=device))
        print(f"{n:>2} {mcs['throughput_cs_per_s']:>10.0f} "
              f"{mcs['cs_p99_all_us']:>8.1f}u "
              f"{tas['throughput_cs_per_s']:>10.0f} "
              f"{tas['cs_p99_all_us']:>8.1f}u")


def figure8b(slos=(20., 40., 60., 80., 100., 150., 200.),
             sim_time_us=50_000.0, device=None):
    print("\n== Figure 8b: LibASL SLO sweep (one batch of cells) ==")
    cfg = sl.SimConfig(policy="libasl", sim_time_us=sim_time_us)
    st = sl.sweep_slo(cfg, list(slos), device=device)
    print(f"{'SLO us':>7} {'tput':>9} {'little p99':>11} {'big p99':>9}")
    for i, slo in enumerate(slos):
        s = sl.summarize(cfg, sl._cell(st, i))
        print(f"{slo:>7.0f} {s['throughput_cs_per_s']:>9.0f} "
              f"{s['ep_p99_little_us']:>10.1f}u "
              f"{s['ep_p99_big_us']:>8.1f}u")


def loadlat(fracs=(0.4, 0.9, 3.0), sim_time_us=20_000.0, device=None):
    print("\n== Load-latency: stochastic workload (repro_torch.workloads) ==")
    rates = [_loadlat_rate(f) for f in fracs]

    def curve(policy, slo_us):
        cfg = sl.SimConfig(policy=policy, wl=True, wl_process="poisson",
                           wl_service="lognormal", wl_cv=1.0,
                           sim_time_us=sim_time_us)
        st, _ = sl.sweep(cfg, {"arrival_rate": rates}, slo_us=slo_us,
                         device=device)
        return [sl.summarize(cfg, sl._cell(st, i))
                for i in range(len(rates))]

    mcs = curve("fifo", 1e9)
    asl = curve("libasl", 200.0)
    print(f"{'load':>5} {'MCS tput':>10} {'MCS p99':>9} "
          f"{'ASL tput':>10} {'ASL p99':>9}")
    for f, m, a in zip(fracs, mcs, asl):
        print(f"{f:>5.1f} {m['throughput_cs_per_s']:>10.0f} "
              f"{m['ep_p99_little_us']:>8.1f}u "
              f"{a['throughput_cs_per_s']:>10.0f} "
              f"{a['ep_p99_little_us']:>8.1f}u")


def openloop(fracs=(0.4, 0.9, 1.1), sim_time_us=20_000.0, device=None):
    print("\n== Open-loop arrivals (wl_open: arrivals as events) ==")
    rates = [_openloop_rate(f) for f in fracs]
    cfg = sl.SimConfig(policy="libasl", wl=True, wl_open=True,
                       wl_process="poisson", sim_time_us=sim_time_us)
    st, _ = sl.sweep(cfg, {"arrival_rate": rates}, slo_us=300.0,
                     device=device)
    print(f"{'load':>5} {'tput':>9} {'sojourn p99':>12}")
    for i, f in enumerate(fracs):
        s = sl.summarize(cfg, sl._cell(st, i))
        print(f"{f:>5.1f} {s['throughput_cs_per_s']:>9.0f} "
              f"{s['ep_p99_all_us']:>11.1f}u")


def keyshard_matrix(locks=8, zipf=0.99, n_keys=1024,
                    sim_time_us=20_000.0, device=None):
    """Every registered policy on the same Zipf-keyed multi-lock workload
    (--locks / --zipf).  The key-affinity policies (ks_*) separate from
    the CRCW baseline (plain fifo) as the traffic gets hotter (--zipf up)
    or the buckets fewer (--locks down)."""
    print(f"\n== Key-sharded matrix: {len(REGISTRY)} policies x "
          f"{locks} locks, Zipf theta={zipf:g} over {n_keys} keys ==")
    print(f"{'policy':>9} {'tput':>9} {'ep p99':>9} {'little p99':>11}")
    for name in REGISTRY:
        cfg = sl.SimConfig(policy=name, sim_time_us=sim_time_us,
                           n_locks=locks, n_keys=n_keys,
                           zipf_theta=zipf)
        s = sl.summarize(cfg, sl.run(cfg, 100.0, device=device))
        print(f"{name:>9} {s['throughput_cs_per_s']:>9.0f} "
              f"{s['ep_p99_all_us']:>8.1f}u "
              f"{s['ep_p99_little_us']:>10.1f}u")


def main(ns=range(1, 9), slos=(20., 40., 60., 80., 100., 150., 200.),
         sim_time_us=40_000.0, fracs=(0.4, 0.9, 3.0), locks=8,
         zipf=0.99, device=None):
    policy_matrix(sim_time_us=sim_time_us / 2, device=device)
    keyshard_matrix(locks, zipf, sim_time_us=sim_time_us / 2,
                    device=device)
    figure1(ns, sim_time_us, device=device)
    figure8b(slos, sim_time_us, device=device)
    loadlat(fracs, sim_time_us=sim_time_us / 2, device=device)
    openloop(sim_time_us=sim_time_us / 2, device=device)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(
        description="Paper-figure lock microbenchmarks on the port")
    ap.add_argument("--locks", type=int, default=8,
                    help="bucket-lock count of the key-sharded matrix")
    ap.add_argument("--zipf", type=float, default=0.99,
                    help="Zipf exponent of the key-sharded matrix "
                         "(0 = uniform, >1 = hot-key collapse)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch version)")
    args = ap.parse_args()
    main(locks=args.locks, zipf=args.zipf, device=args.device)
    from repro_torch.kernels import simstep
    print(f"fused_chunk launches: {simstep.fused_chunk.launches}")
