#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, no result line):

1. Print the card (``nvidia-smi``) and build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` with ``nvcc``.
2. Hold the ``fused_chunk`` kernel against its plain PyTorch version on
   the card, bit for bit in every state leaf: each policy on the fig1 and
   Bench-1 programs over a small grid, chunk 1 against chunk 128, and one
   launch at the main path's shapes (timed, with its bound).
3. Drive the main path at full size through ``sweep``: the paper's fig1
   calibration for 60,000 us, one sweep per policy (2,120 cells), with
   the kernel launch counters set to 0 just before and read just after.
   Every cell must retire events, the n_cores=8 summaries must be
   finite, and the n_cores=8 (seed 0) cells must equal the JAX package's
   final state bit for bit (``REFERENCE_DIGESTS``).
4. Print the kernel table (JSON) and, last, the device line.

It exits non-zero when no CUDA device is present, and when the port's
package is not next to it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM non-tensor f32 rate

# Fig1 calibration (benchmarks/paper_figs.py): 4 big + 4 little cores, CS
# 3 us, non-CS 1 us, inter-epoch 5 us, CS ratio 3.75, non-CS ratio 1.8.
CS_RATIO, NC_RATIO = 3.75, 1.8
BIG = (1, 1, 1, 1, 0, 0, 0, 0)
FIG1 = dict(n_cores=8, big=BIG,
            speed_cs=tuple(1.0 if b else CS_RATIO for b in BIG),
            speed_nc=tuple(1.0 if b else NC_RATIO for b in BIG),
            seg_noncrit_us=(1.0,), seg_cs_us=(3.0,), seg_lock=(0,),
            inter_epoch_us=5.0)
# Bench-1 program: 4 critical sections over 2 locks.
BENCH1 = dict(FIG1, seg_noncrit_us=(1.0, 0.5, 0.5, 0.5),
              seg_cs_us=(2.0, 1.0, 3.0, 0.5), seg_lock=(0, 1, 0, 1),
              n_locks=2, inter_epoch_us=7.5)
POLICIES = ("fifo", "tas", "prop", "libasl")
MAIN_US = 60_000.0
SEEDS = list(range(16))
MAIN_GRID = {
    "libasl": {"n_cores": list(range(1, 9)),
               "slo_us": [20.0, 40.0, 60.0, 80.0, 120.0, 200.0, 400.0, 1e9],
               "seed": SEEDS},
    "tas": {"n_cores": list(range(1, 9)),
            "w_big": [0.15, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0],
            "seed": SEEDS},
    # prop and fifo draw no random numbers in closed loop: no seed axis.
    "prop": {"n_cores": list(range(1, 9)),
             "prop_n": [1, 2, 5, 10, 20, 50, 100, 200]},
    "fifo": {"n_cores": list(range(1, 9))},
}
# The fig1 headline cell of each policy at n_cores=8 (paper_figs FIG1_KW).
HEADLINE = {"libasl": {"slo_us": 1e9, "seed": 0},
            "tas": {"w_big": 0.15, "seed": 0},
            "prop": {"prop_n": 10}, "fifo": {}}
# sha256 (state_digest) of the JAX package's final state for the
# n_cores=8, seed=0 cells of each main-path sweep, full length.
# tests/test_torch_main_path.py recomputes them with JAX.
REFERENCE_DIGESTS = {
    "libasl": "67459abc348cd5f907ccad20a387df9bfb6f1bebc2351392edd00e0370f3787f",
    "tas": "78f6d1e19b2bb274055ee777bc6f3b5242c27219b04de34bdb56209f909cdb8b",
    "prop": "d7115a6a4513c7b3436bcedf841f647839cdb7b4383c636be18fd637efb11036",
    "fifo": "b8988c59669d2b40feb5bc26e750a41cb9cd7ee5633894a9dd4f0b4bd452dba1",
}


def reference_cells(grid) -> "np.ndarray":
    """Indices of the cells REFERENCE_DIGESTS covers, in grid order."""
    import numpy as np
    keep = grid["n_cores"] == 8
    if "seed" in grid:
        keep &= grid["seed"] == 0
    return np.nonzero(keep)[0]


def state_digest(st) -> str:
    """sha256 over the state's leaves (numpy, reference dtypes) in field
    order."""
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for k in st._fields:
        if k != "pol":
            h.update(np.ascontiguousarray(np.asarray(getattr(st, k)))
                     .tobytes())
    return h.hexdigest()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def clone(st):
    return type(st)(**{k: v if k == "pol" else v.clone()
                       for k, v in st._asdict().items()})


def leaf_diff(a, b) -> tuple:
    """(names of leaves that differ, max abs difference over all leaves)."""
    import torch
    bad, err = [], 0.0
    for k in a._fields:
        if k == "pol":
            continue
        x, y = getattr(a, k), getattr(b, k)
        if not torch.equal(x, y):
            bad.append(k)
        d = (x.double() - y.double()).abs().max().item() if x.numel() else 0
        err = max(err, float(d))
    return bad, err


def phase_parity(sl, simstep) -> None:
    """Kernel == plain version on the card, every leaf, small grids."""
    import torch
    axes = {"n_cores": [4, 8], "slo_us": [40.0, 90.0], "seed": [0, 1, 2, 3]}
    for pol in POLICIES:
        for prog, kw in (("fig1", FIG1), ("bench1", BENCH1)):
            cfg = sl.SimConfig(policy=pol, sim_time_us=4000.0, **kw)
            tb, pm, st, _ = sl.init_sweep(cfg, axes, device="cuda")
            ref = clone(st)
            n0 = simstep.fused_chunk.launches
            kernel_ms = cuda_ms(lambda: sl.simulate(cfg, tb, pm, st))
            plain_ms = cuda_ms(lambda: sl.simulate(
                cfg, tb, pm, ref, chunk_fn=simstep.fused_chunk_ref))
            bad, _ = leaf_diff(st, ref)
            n = simstep.fused_chunk.launches - n0
            print(f"parity {pol}/{prog}: 16 cells, "
                  f"{int(st.events.sum())} events, {n} launches, kernel "
                  f"{kernel_ms / 1e3:.3f} s, plain {plain_ms / 1e3:.1f} s, "
                  f"differing leaves: {bad or 'none'}", flush=True)
            if bad or n <= 0:
                raise AssertionError(f"kernel != plain for {pol}/{prog}")
    cfg = sl.SimConfig(policy="libasl", sim_time_us=4000.0, **FIG1)
    tb, pm, st, _ = sl.init_sweep(cfg, axes, device="cuda")
    one = clone(st)
    sl.simulate(cfg, tb, pm, st)
    import dataclasses
    sl.simulate(dataclasses.replace(cfg, chunk=1), tb, pm, one)
    torch.cuda.synchronize()
    bad, _ = leaf_diff(st, one)
    print(f"parity libasl chunk=1 vs chunk=128: differing leaves: "
          f"{bad or 'none'}", flush=True)
    if bad:
        raise AssertionError("chunk=1 != chunk=128")


def cuda_ms(fn) -> float:
    import torch
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def launch_bound(tb, pm, cfg, simstep, before, after, launches) -> tuple:
    """Least time for one launch on this run's data (``launches`` of them
    took ``before`` to ``after``): in each launch every cell that retires
    an event reads the kernel's tables, params and state (rings excepted)
    once and writes its state once, and each recorded latency writes one
    4-byte ring sample.  The operations (argmin compares and handler
    steps per event) take far less time than the bytes."""
    ts, _ = simstep._operands(tb, pm, before, cfg)
    state = set(before._fields)
    per_cell = sum((2 if k in state else 1) * x[0].numel() * x.element_size()
                   for k, x in ts.items() if k not in ("ep_lat", "cs_lat"))
    ev = after.events - before.events
    samples = int((after.ep_cnt - before.ep_cnt).sum()
                  + (after.cs_cnt - before.cs_cnt).sum())
    n_bytes = int((ev > 0).sum()) * per_cell + 4 * samples / launches
    ops = int(ev.sum()) * (2 * before.t_ready.shape[1] + 64) / launches
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def phase_main_shape(sl, simstep) -> dict:
    """Launches at the main path's shapes (libasl grid, 1,024 cells), the
    kernel against the plain version from the same mid-run state: 10
    chunks back to back (so the wrapper's host work hides behind the
    card's), timed per launch, then every leaf compared."""
    import torch
    reps = 10
    cfg = sl.SimConfig(policy="libasl", sim_time_us=MAIN_US, **FIG1)
    tb, pm, st, _ = sl.init_sweep(cfg, MAIN_GRID["libasl"], device="cuda")
    for _ in range(20):                  # into the steady state
        simstep.fused_chunk(tb, pm, st, cfg.chunk, cfg)
    torch.cuda.synchronize()

    def chunks(fn, state):
        for _ in range(reps):
            fn(tb, pm, state, cfg.chunk, cfg)

    ms = []
    for _ in range(3):
        k = clone(st)
        ms.append(cuda_ms(lambda: chunks(simstep.fused_chunk, k)) / reps)
    p = clone(st)
    plain_ms = cuda_ms(lambda: chunks(simstep.fused_chunk_ref, p)) / reps
    bad, err = leaf_diff(k, p)
    kernel_ms = sorted(ms)[1]
    print(f"main-shape launches: {st.events.numel()} cells x chunk "
          f"{cfg.chunk}, kernel "
          f"{kernel_ms:.4f} ms/launch (of {[round(m, 4) for m in ms]}), "
          f"plain {plain_ms:.2f} ms/chunk, differing leaves: "
          f"{bad or 'none'}, max abs err {err}", flush=True)
    if bad:
        raise AssertionError("kernel != plain at the main-path shapes")
    bound, by = launch_bound(tb, pm, cfg, simstep, st, k, reps)
    return {"ms": kernel_ms, "plain_ms": plain_ms, "max_abs_err": err,
            "bound_ms": bound, "bound_by": by}


def phase_main(sl, simstep) -> dict:
    """The main path: four full-size sweeps through the kernel."""
    import numpy as np
    import torch
    torch.cuda.reset_peak_memory_stats()
    simstep.fused_chunk.launches = 0
    runs = {}
    for pol in ("libasl", "tas", "prop", "fifo"):
        cfg = sl.SimConfig(policy=pol, sim_time_us=MAIN_US, epcap=8192,
                           **FIG1)
        n0 = simstep.fused_chunk.launches
        out = {}
        ms = cuda_ms(lambda: out.update(zip(
            ("st", "grid"), sl.sweep(cfg, MAIN_GRID[pol], device="cuda"))))
        runs[pol] = (cfg, out["st"], out["grid"], ms,
                     simstep.fused_chunk.launches - n0)
    launches = simstep.fused_chunk.launches
    peak = torch.cuda.max_memory_allocated()
    total_ev, total_ms = 0, 0.0
    for pol, (cfg, st, grid, ms, n) in runs.items():
        ev = st.events.cpu().numpy()
        total_ev += int(ev.sum())
        total_ms += ms
        print(f"main {pol}: {ev.size} cells, {int(ev.sum())} events, "
              f"{ms / 1e3:.3f} s, {ev.sum() / (ms / 1e3):.0f} events/s, "
              f"{n} launches", flush=True)
        horizon = int(round(MAIN_US * 100))     # ticks
        if (ev <= 0).any() or int(st.t.max()) >= horizon:
            raise AssertionError(f"{pol}: a cell retired no event or ran "
                                 f"past its horizon")
        ref = reference_cells(grid)
        got = state_digest(sl.to_reference(type(st)(**{
            k: v if k == "pol" else v[torch.as_tensor(ref)]
            for k, v in st._asdict().items()})))
        same = got == REFERENCE_DIGESTS[pol]
        print(f"main {pol}: {len(ref)} n_cores=8 cells "
              f"{'bit-identical to' if same else 'DIFFER from'} the JAX "
              f"reference (sha256 {got[:16]})", flush=True)
        if not same:
            raise AssertionError(f"{pol}: main-path cells differ from JAX")
        sel = np.nonzero(grid["n_cores"] == 8)[0]
        sub = type(st)(**{k: v if k == "pol" else v[torch.as_tensor(sel)]
                          for k, v in st._asdict().items()})
        summ = sl.sweep_summaries(cfg, sub,
                                  {k: v[sel] for k, v in grid.items()})
        # Every cell: finite positive throughput; a tail percentile may be
        # nan only where a core class kept no sample past the warmup.
        for s in summ:
            tail = [s[k] for k in ("ep_p99_big_us", "ep_p99_little_us",
                                   "cs_p99_all_us")]
            if not (np.isfinite(s["throughput_cs_per_s"])
                    and s["throughput_cs_per_s"] > 0
                    and all(np.isnan(v) or 0 < v < np.inf for v in tail)):
                raise AssertionError(f"{pol}: bad summary {s}")
        head = next(s for s in summ if all(
            np.isclose(float(s[k]), v) for k, v in HEADLINE[pol].items()))
        if not all(np.isfinite(head[k]) for k in (
                "ep_p99_big_us", "ep_p99_little_us", "cs_p99_all_us")):
            raise AssertionError(f"{pol}: headline cell not finite {head}")
        print(f"fig1 headline {pol} n_cores=8 "
              + " ".join(f"{k}={v}" for k, v in HEADLINE[pol].items())
              + f": throughput_cs_per_s={head['throughput_cs_per_s']:.1f} "
              f"ep_p99_big_us={head['ep_p99_big_us']:.2f} "
              f"ep_p99_little_us={head['ep_p99_little_us']:.2f}",
              flush=True)
    print(f"main path: {sum(len(r[1].events) for r in runs.values())} "
          f"cells, {total_ev} events in {total_ms / 1e3:.3f} s "
          f"({total_ev / (total_ms / 1e3):.0f} events/s), {launches} "
          f"fused_chunk launches, max_memory_allocated "
          f"{peak / 2**30:.3f} GiB", flush=True)
    if launches <= 0:
        raise AssertionError("the main path launched no fused_chunk kernel")
    return {"launches": launches}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from repro_torch.core import simlock as sl
        from repro_torch.kernels import build, simstep
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e}); run from "
              f"the repository root", file=sys.stderr)
        return 1
    try:
        card = card_line()
        print(card, flush=True)
        t0 = time.time()
        logs = build.build()
        print(f"built {sorted(logs) or 'nothing (cached)'} in "
              f"{time.time() - t0:.1f} s", flush=True)
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        phase_parity(sl, simstep)
        shape = phase_main_shape(sl, simstep)
        main_run = phase_main(sl, simstep)
    except Exception:
        traceback.print_exc()
        return 1
    kernels = [dict(
        name="fused_chunk", route="cuda",
        source="src/repro_torch/kernels/csrc/simstep.cu",
        replaces="src/repro/kernels/simstep.py:65",
        launches=main_run["launches"], max_abs_err=shape["max_abs_err"],
        ms=shape["ms"], plain_ms=shape["plain_ms"],
        bound_ms=shape["bound_ms"], bound_by=shape["bound_by"],
        library_ms=None)]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
