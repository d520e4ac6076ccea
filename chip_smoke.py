#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, no result line):

1. Print the card (``nvidia-smi``) and build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` (one process per
   source, all started together).
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
4. Hold the ``mlstm_scan`` kernel against its plain PyTorch version on
   the card: f32 and bf16 inputs, with and without a carry, S in {1, 7,
   256}, dh in {32, 192}; h, C, n and m within the JAX package's kernel
   bar (``tests/test_kernels.py``: 10 x TOL on h, 1e-4 on C and n, 1e-5
   on m).  Time one launch at the serving shapes, with its bound.
5. Serve xlstm-125m at its full config (130,425,648 parameters, bf16)
   through ``repro_torch.launch.serve.main``: one calibration, then the
   asl, fifo and greedy schedulers on that cost model, with the
   ``mlstm_scan`` launch counter set to 0 just before and read just
   after.
6. The full-width xLSTM model against its plain path on the card:
   prefill 256 tokens then 8 decode steps through the kernel and through
   the plain version; logits within 10 x TOL[bf16] = 0.2.  Then where a
   prefill's and a decode step's time goes, block by block.
7. Hold ``flash_attention`` against its plain version on the card (f32
   and bf16, head dims 64, 128 and 256, GQA groups 1 and 8 and recurrentgemma's
   10 q heads on 1 kv head, ragged S and T, causal or not, window 0 or
   64) within the JAX package's kernel bar (TOL), then time it at the
   yi-6b and recurrentgemma-2b prefill shapes beside its bound, the
   plain version and PyTorch's fused attention.
8. The same for ``decode_attention`` (per-row lengths 1, 257, 511, T and
   a mix, T of 512 and 300; and ring starts: a local block's ring of 17
   slots with window 16 at positions 16, 17, 40 and a mix), timed at the
   yi-6b and recurrentgemma-2b decode shapes.
9. yi-6b at its full config (6,061,035,520 parameters, f32 at rest, bf16
   compute): a prefill of 8 x 256 tokens and 8 decode steps through the
   kernels and through the plain versions, logits within 3 % of the
   largest; then a prefill's and a decode step's time split into the
   weight casts, projections, attention and FFN, and the card's busy
   time in each from ``torch.profiler`` (the device idle share).
10. Serve yi-6b: one calibration, then asl, fifo and greedy on that cost
    model at a rate that puts half of the slot on prefill, TTFT SLO 4 x
    the mean prompt's prefill, with both attention counters set to 0
    just before and read just after; then the
    ``python -m repro_torch.launch.serve --arch yi-6b`` CLI once at that
    rate, in its own process.  The yi-6b weights are freed.
11. Hold ``rglru_scan`` against its plain version on the card, bit for
    bit in f32 and within 5 x TOL in bf16: with and without h0, S in {1,
    7, 256}, R in {2560, 100}, a in (0, 1); time one launch at the
    serving shape beside its bound and the plain version.
12. recurrentgemma-2b at its full config (2,658,736,640 parameters, f32
    at rest, bf16 compute): a prefill of 8 x 256 tokens and 8 decode
    steps through the kernels and through the plain versions, logits
    within 3 % of the largest; a prefill's and a decode step's time
    split into the weight casts, RG-LRU projections, conv and gates,
    ``rglru_scan``, attention projections, attention, FFN and
    unembedding; the device idle share from ``torch.profiler``.
13. Serve recurrentgemma-2b: one calibration, then asl, fifo and greedy
    on that cost model at a rate set from both calibrated costs
    (0.5 / (4.667 prefill chunks + 80 decode steps)), TTFT SLO 4 x the
    mean prompt's prefill, with the ``rglru_scan``, ``flash_attention``
    and ``decode_attention`` counters set to 0 just before and read just
    after.
14. Print the kernel table (JSON), the card and, last, the device line.

It exits non-zero when no CUDA device is present, and when the port's
package is not next to it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM non-tensor f32 rate
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate

# The serving path: xlstm-125m at its full config, the calibration's
# shapes (launch/serve.py: batch 8, prefill chunk 256), and a Poisson
# stream sized to the calibrated cost on one H100 (a 256-token chunk of
# 8 sequences takes 0.36-0.62 s there, so 0.25 requests/s of
# ~1,200-token prompts keeps the engine busy most of the time) with a
# TTFT SLO of 8 s.
ARCH = "xlstm-125m"
N_PARAMS = 130_425_648
SERVE_BATCH, SERVE_CHUNK = 8, 256
SERVE_ARGS = ["--rate", "0.25", "--duration", "600", "--slo-ttft", "8"]
SCHEDULERS = ("asl", "fifo", "greedy")
# The JAX package's kernel bar (tests/test_kernels.py: TOL, and 10 x TOL
# on h), and the model's logits against its plain path at 10 x TOL[bf16].
MLSTM_TOL = {"float32": 3e-4, "bfloat16": 0.2}
LOGITS_TOL = 0.2

# The yi-6b and recurrentgemma-2b serving paths: each at its full
# config, the same calibration shapes, and a 600 s stream whose rate the
# calibration sets, with a TTFT SLO of 4 x the mean prompt's prefill.
# yi-6b puts half of the engine's slot on prefill; recurrentgemma-2b
# half on the mean request, its prompt's 4.667 prefill chunks and 80
# decode steps at batch 1 (t_cache 512, inside its 2048-token window).
# The attention kernels are held to the JAX package's kernel bar
# (tests/test_kernels.py: TOL, absolute and relative), rglru_scan to its
# plain version bit for bit in f32 and to that file's bar for it in bf16
# (5 x TOL); the models' logits, kernel path against plain path, to 3 %
# of the largest logit (the bar tests/test_torch_yi.py and
# tests/test_torch_recurrentgemma.py hold the models to against JAX in
# bf16).
YI = "yi-6b"
YI_PARAMS = 6_061_035_520
RG = "recurrentgemma-2b"
RG_PARAMS = 2_658_736_640
SERVE_DURATION_S = 600.0
MODEL_LOGITS_TOL = 0.03
ATTN_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
RGLRU_TOL = {"float32": 0.0, "bfloat16": 5 * ATTN_TOL["bfloat16"]}

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


def instantiation(line: str) -> str:
    """The template arguments of the kernel that ptxas's "Compiling entry
    function" line names, readable: (f32, 256) for ``...IfLi256EE...``."""
    import re
    m = re.search(r"_kernelI(.*?)EEv", line)
    if not m:
        return ""
    args = m.group(1).replace("13__nv_bfloat16", "bf16,").replace(
        "Li", "").replace("E", ",")
    args = re.sub(r"^f", "f32,", args)
    return "(" + ", ".join(a for a in args.split(",") if a) + ")"


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


def mlstm_inputs(gen, b, h, s, dh, dtype, carry):
    """Random q, k (scaled by 1/sqrt(dh)), v in ``dtype``, f32 gates (the
    forget gate biased open, as the model initializes it) and, if asked,
    a positive f32 carry, all on the card."""
    import torch
    f = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    q, k, v = f(b, h, s, dh), f(b, h, s, dh) / dh ** 0.5, f(b, h, s, dh)
    args = [t.to(dtype) for t in (q, k, v)] + [f(b, h, s), f(b, h, s) + 2.0]
    c = (f(b, h, dh, dh).abs() * 0.1, f(b, h, dh).abs() * 0.1,
         f(b, h) * 0.5) if carry else None
    return args, c


def mlstm_diff(got, want, dtype) -> tuple:
    """(max abs error of h, C, n, m; within the stated tolerance?)"""
    import torch
    (h, c), (wh, wc) = got, want
    pairs = [(h.float(), wh.float(), MLSTM_TOL[dtype])] + [
        (a, b, tol) for a, b, tol in zip(c, wc, (1e-4, 1e-4, 1e-5))]
    errs = [float((a - b).abs().max()) for a, b, _ in pairs]
    ok = all(torch.allclose(a, b, atol=tol, rtol=tol) for a, b, tol in pairs)
    return errs, ok


def mlstm_bound(b, h, s, dh, esize, carry) -> tuple:
    """Least time of one scan on the card: each input and output touched
    once (q, k, v, h in their type; gates, carry in and out in f32), and
    per step and head 6 dh^2 + 6 dh f32 operations (C update 4 dh^2,
    readout 2 dh^2, n update, n.q and the division 6 dh) plus ~10 for the
    gates, over the non-tensor f32 rate."""
    state = b * h * (dh * dh + dh + 1) * 4
    n_bytes = (4 * b * h * s * dh * esize + 2 * b * h * s * 4
               + state * (2 if carry else 1))
    ops = b * h * s * (6 * dh * dh + 6 * dh + 10)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def phase_mlstm(ms) -> dict:
    """mlstm_scan == its plain version on the card over the listed cases,
    then one launch at the serving shapes timed against its bound."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n_bad = 0
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for dh in (32, 192):
            for s in (1, 7, 256):
                for carry in (False, True):
                    args, c = mlstm_inputs(gen, 2, 4, s, dh, dtype, carry)
                    n0 = ms.mlstm_scan.launches
                    got = ms.mlstm_scan(*args, c)
                    torch.cuda.synchronize()
                    want = ms.mlstm_scan_ref(*args, c)
                    errs, ok = mlstm_diff(got, want, dname)
                    ok = ok and ms.mlstm_scan.launches == n0 + 1
                    n_bad += not ok
                    print(f"mlstm_scan {dname} B=2 H=4 S={s} dh={dh} "
                          f"carry={carry}: max abs err h/C/n/m "
                          f"{' '.join(f'{e:.3g}' for e in errs)} "
                          f"{'ok' if ok else 'OVER TOLERANCE'}", flush=True)
    if n_bad:
        raise AssertionError(f"mlstm_scan != plain version in {n_bad} cases")
    # The serving shapes: a prefill chunk of the calibration, as the model
    # calls the kernel (f32 q, k, v and gates, no carry).
    b, h, s, dh = SERVE_BATCH, 4, SERVE_CHUNK, 192
    args, _ = mlstm_inputs(gen, b, h, s, dh, torch.float32, False)
    for _ in range(3):
        ms.mlstm_scan(*args)
    reps, times = 10, []
    for _ in range(3):
        times.append(cuda_ms(lambda: [ms.mlstm_scan(*args)
                                      for _ in range(reps)]) / reps)
    got = ms.mlstm_scan(*args)
    out = {}
    plain_ms = cuda_ms(lambda: out.update(want=ms.mlstm_scan_ref(*args)))
    errs, ok = mlstm_diff(got, out["want"], "float32")
    kernel_ms = sorted(times)[1]
    bound, by = mlstm_bound(b, h, s, dh, 4, False)
    print(f"mlstm_scan serving shapes B={b} H={h} S={s} dh={dh} f32: kernel "
          f"{kernel_ms:.4f} ms/launch (of {[round(t, 4) for t in times]}), "
          f"plain {plain_ms:.2f} ms, bound {bound:.5f} ms ({by}), max abs "
          f"err h {errs[0]:.3g}", flush=True)
    if not ok:
        raise AssertionError("mlstm_scan != plain at the serving shapes")
    # The decode shapes: one step from a carry.
    args1, c1 = mlstm_inputs(gen, b, h, 1, dh, torch.float32, True)
    dec_ms = cuda_ms(lambda: [ms.mlstm_scan(*args1, c1)
                              for _ in range(100)]) / 100
    errs1, ok1 = mlstm_diff(ms.mlstm_scan(*args1, c1),
                            ms.mlstm_scan_ref(*args1, c1), "float32")
    print(f"mlstm_scan decode shapes B={b} H={h} S=1 dh={dh} with carry: "
          f"kernel {dec_ms:.4f} ms/launch, bound "
          f"{mlstm_bound(b, h, 1, dh, 4, True)[0]:.5f} ms, max abs err "
          f"h/C/n/m {' '.join(f'{e:.3g}' for e in errs1)}", flush=True)
    if not ok1:
        raise AssertionError("mlstm_scan != plain at the decode shapes")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "max_abs_err": errs[0],
            "bound_ms": bound, "bound_by": by}


def check_serve_runs(arch, n, dtype, cost, runs) -> None:
    """Print each scheduler's row; fail on a run that answered nothing or
    gave a metric that is not finite."""
    import math
    for sched, m in runs.items():
        print(f"serve {arch} ({n} parameters, {dtype}) {sched}: "
              f"decode {cost['decode_step_s'] * 1e3:.2f} ms, prefill chunk "
              f"{cost['prefill_chunk_s'] * 1e3:.2f} ms, n={m['n']}, "
              f"tok/s={m.get('throughput_tok_s', float('nan')):.1f}, "
              f"TTFT P99 {m.get('ttft_p99', float('nan')) * 1e3:.1f} ms, "
              f"ITL P99 {m.get('itl_p99', float('nan')) * 1e3:.1f} ms, "
              f"violations {m.get('slo_violation_rate', float('nan')):.1%}",
              flush=True)
        if m["n"] <= 0 or not all(math.isfinite(m[k]) for k in (
                "throughput_tok_s", "ttft_p99", "itl_p99")):
            raise AssertionError(f"serve {sched}: bad metrics {m}")


def phase_serve(ms) -> dict:
    """The serving path: xlstm-125m at full config, calibrated once on the
    card, then the asl, fifo and greedy schedulers each answering the
    same Poisson stream on that cost model; the kernel counter is read
    just after."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = registry.get(ARCH)[0]
    n = lm.n_params(cfg)
    if n != N_PARAMS or cfg.dtype != "bfloat16":
        raise AssertionError(f"{ARCH}: {n} parameters in {cfg.dtype}")
    ms.mlstm_scan.launches = 0
    out = serve.main(["--arch", ARCH, "--scheduler", *SCHEDULERS]
                     + SERVE_ARGS)
    launches = ms.mlstm_scan.launches
    check_serve_runs(ARCH, n, cfg.dtype, out, out["by_scheduler"])
    print(f"serve: {launches} mlstm_scan launches (one calibration)",
          flush=True)
    if launches <= 0:
        raise AssertionError("the serving path launched no mlstm_scan")
    return {"launches": launches}


def timed_blocks(lm, p, cfg, x, cache, table, **kw) -> tuple:
    """Run the blocks of ``lm``'s step one by one (as ``lm.prefill`` /
    ``lm.decode_step`` do), each bracketed by synchronisations; ->
    (output, new cache, seconds per block kind)."""
    import torch
    spent = {}
    new = []
    for lp, lc, kind in zip(p["blocks"], cache, cfg.blocks()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, nc = table[kind](lp, x, cfg, cache=lc, **kw)
        torch.cuda.synchronize()
        spent[kind] = spent.get(kind, 0.0) + time.perf_counter() - t0
        new.append(nc)
    return x, new, spent


def phase_model(ms) -> None:
    """Full-width xlstm-125m on the card: prefill 256 tokens and 8 decode
    steps through the kernel and through the plain version, logits held
    together; then the block-by-block split of one prefill and one
    decode step."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm
    cfg = registry.get(ARCH)[0]
    params = lm.init_params(cfg, 0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    b, s = SERVE_BATCH, SERVE_CHUNK
    toks = torch.randint(0, cfg.vocab, (b, s + 8), generator=gen,
                         device="cuda")
    logits = {}
    for path, scan in (("kernel", None), ("plain", ms.mlstm_scan_ref)):
        n0 = ms.mlstm_scan.launches
        out, cache = lm.prefill(params, cfg, {"tokens": toks[:, :s]},
                                lm.init_cache(cfg, b, 512, "cuda"),
                                mlstm_scan=scan)
        steps = [out]
        lengths = torch.full((b,), s, dtype=torch.int32, device="cuda")
        for i in range(8):
            out, cache, lengths = lm.decode_step(
                params, cfg, toks[:, s + i:s + i + 1], lengths, cache,
                mlstm_scan=scan)
            steps.append(out)
        logits[path] = torch.cat(steps, dim=1)
        n = ms.mlstm_scan.launches - n0
        print(f"model {path} path: prefill {s} + 8 decode steps, "
              f"{n} mlstm_scan launches", flush=True)
    a, w = logits["kernel"], logits["plain"]
    err = float((a - w).abs().max())
    mean = float((a - w).abs().mean())
    ok = bool(torch.isfinite(a).all()) and a.shape == (b, 9, cfg.vocab) \
        and err <= LOGITS_TOL
    print(f"model kernel vs plain logits over 9 steps: max abs diff {err:.4g} "
          f"(mean {mean:.3g}, largest logit {float(w.abs().max()):.3g}), "
          f"tolerance {LOGITS_TOL}: {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError("model logits: kernel path != plain path")
    # Where a prefill's and a decode step's time goes.
    p = params.tree()
    x = lm._embed_tokens(p, cfg, toks[:, :s])
    cache = lm.init_cache(cfg, b, 512, "cuda")
    n0 = ms.mlstm_scan.launches
    timed_blocks(lm, p, cfg, x, cache, lm.BLOCK_PREFILL)      # warm
    x, cache, pre = timed_blocks(lm, p, cfg, x, cache, lm.BLOCK_PREFILL)
    per_prefill = (ms.mlstm_scan.launches - n0) // 2
    x1 = lm._embed_tokens(p, cfg, toks[:, s:s + 1])
    n0 = ms.mlstm_scan.launches
    _, _, dec = timed_blocks(lm, p, cfg, x1, cache, lm.BLOCK_DECODE)
    per_decode = ms.mlstm_scan.launches - n0
    for name, spent, n in (("prefill", pre, per_prefill),
                           ("decode", dec, per_decode)):
        tot = sum(spent.values())
        print(f"blocks of one {name}: " + ", ".join(
            f"{k} {v * 1e3:.2f} ms ({v / tot:.1%})"
            for k, v in spent.items())
              + f"; {n} mlstm_scan launches", flush=True)


# ---------------------------------------------------------------------------
# yi-6b: flash_attention, decode_attention, the model and its server
# ---------------------------------------------------------------------------

def attn_tol(dtype) -> float:
    return ATTN_TOL[str(dtype).replace("torch.", "")]


def library_attention(q, k, v, causal):
    """PyTorch's fused attention on the same inputs: the yardstick timed
    beside each kernel (``library_ms``); the port never calls it."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def median_ms(fn, reps=10) -> tuple:
    """(median, all) of 3 timings of ``reps`` back-to-back calls, in ms
    per call, after 3 warm calls."""
    for _ in range(3):
        fn()
    times = [cuda_ms(lambda: [fn() for _ in range(reps)]) / reps
             for _ in range(3)]
    return sorted(times)[1], times


def bound(n_bytes, flops) -> tuple:
    """The least time of the work: bytes over the memory rate or bf16
    tensor-core operations over their peak, the larger."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def flash_case(fa, gen, b, h, kh, s, t, dh, dtype, causal, window) -> tuple:
    """One launch against the plain version; -> (max abs err over rows
    with a valid key, ok)."""
    import torch
    f = lambda *shape: torch.randn(*shape, generator=gen, device="cuda") \
        .to(dtype)
    q, k, v = f(b, h, s, dh), f(b, kh, t, dh), f(b, kh, t, dh)
    n0 = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    seen = torch.isfinite(want)          # rows with no valid key are NaN
    a, w, tol = got.float()[seen], want.float()[seen], attn_tol(dtype)
    err = float((a - w).abs().max()) if a.numel() else 0.0
    ok = (torch.allclose(a, w, atol=tol, rtol=tol)
          and bool(torch.isfinite(got).all())
          and fa.flash_attention.launches == n0 + 1
          and got.shape == q.shape and got.dtype == q.dtype)
    return err, ok


# (H, K, dh) of the sweeps: GQA groups 1 and 8 at head dims 64, 128 and
# 256, and recurrentgemma-2b's 10 q heads on one kv head of 256.
FLASH_HEADS = [(8, 8 // g, dh) for dh in (64, 128, 256) for g in (1, 8)] \
    + [(10, 1, 256)]
DECODE_HEADS = [(32, 32 // g, dh) for dh in (64, 128, 256) for g in (1, 8)] \
    + [(10, 1, 256)]


def flash_timing(fa, gen, b, h, kh, s, dh, window) -> dict:
    """One causal prefill shape in bf16, in the model's layout
    (transposed views): the kernel timed against its bound, the plain
    version and PyTorch's fused attention."""
    import torch
    f = lambda *shape: torch.randn(*shape, generator=gen, device="cuda") \
        .to(torch.bfloat16)
    q, k, v = (x.transpose(1, 2) for x in (f(b, s, h, dh), f(b, s, kh, dh),
                                            f(b, s, kh, dh)))
    kernel_ms, times = median_ms(
        lambda: fa.flash_attention(q, k, v, causal=True, window=window))
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    out = {}
    plain_ms = cuda_ms(lambda: out.update(want=fa.flash_attention_ref(
        q, k, v, causal=True, window=window)))
    err = float((got.float() - out["want"].float()).abs().max())
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    lib_ms, _ = median_ms(lambda: library_attention(qc, kc, vc, True))
    _, dev_ms, _ = device_busy(
        lambda: fa.flash_attention(q, k, v, causal=True, window=window), 10)
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    # The causal products; a window of 0 or >= S masks nothing more.
    flops = 2 * 2 * b * h * s * (s + 1) // 2 * dh
    bnd, by = bound(n_bytes, flops)
    print(f"flash_attention B={b} H={h} K={kh} S=T={s} dh={dh} window="
          f"{window} bf16 causal: kernel {kernel_ms:.4f} ms/launch (of "
          f"{[round(x, 4) for x in times]}; on the card {dev_ms:.4f}), "
          f"plain {plain_ms:.3f} ms, "
          f"library {lib_ms:.4f} ms, bound {bnd:.5f} ms ({by}; "
          f"{n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), max abs err "
          f"{err:.3g}", flush=True)
    if err > attn_tol(torch.bfloat16):
        raise AssertionError(f"flash_attention != plain at B={b} H={h} "
                             f"K={kh} S={s} dh={dh}")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "max_abs_err": err,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms}


def phase_flash(fa) -> dict:
    """flash_attention == its plain version on the card over the sweep,
    then the yi-6b and recurrentgemma-2b prefill shapes timed against
    their bounds, the plain version and PyTorch's fused attention.
    -> the yi-6b shape's numbers (the kernel table's)."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    n_bad = n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for h, kh, dh in FLASH_HEADS:
            for s, t in ((128, 128), (200, 200), (1, 200), (200, 1),
                         (77, 300)):
                for causal in (True, False):
                    for window in (0, 64):
                        err, ok = flash_case(fa, gen, 2, h, kh, s, t, dh,
                                             dtype, causal, window)
                        n_cases += 1
                        n_bad += not ok
                        if not ok:
                            print(f"flash_attention {dtype} H={h} K={kh} "
                                  f"dh={dh} S={s} T={t} causal={causal} "
                                  f"window={window}: max abs err {err:.3g} "
                                  f"OVER TOLERANCE", flush=True)
    print(f"flash_attention sweep: {n_cases - n_bad}/{n_cases} cases "
          f"within tolerance (f32/bf16 x (H, K, dh) in {FLASH_HEADS} x "
          f"S,T in 128/128 200/200 1/200 200/1 77/300 x causal x window "
          f"0/64)", flush=True)
    if n_bad:
        raise AssertionError(f"flash_attention != plain in {n_bad} cases")
    yi = flash_timing(fa, gen, SERVE_BATCH, 32, 4, SERVE_CHUNK, 128, 0)
    flash_timing(fa, gen, SERVE_BATCH, 10, 1, SERVE_CHUNK, 256, 2048)
    return yi


def decode_case(da, gen, b, h, kh, t, dh, dtype, lengths,
                starts=None) -> tuple:
    """One launch against the plain version, the caches as transposed
    views of [B,T,K,dh] (the model's layout); -> (max abs err, ok)."""
    import torch
    f = lambda *shape: torch.randn(*shape, generator=gen, device="cuda") \
        .to(dtype)
    q = f(b, h, dh)
    kc, vc = (f(b, t, kh, dh).transpose(1, 2) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if starts is not None:
        starts = torch.tensor(starts, dtype=torch.int32, device="cuda")
    n0 = da.decode_attention.launches
    got = da.decode_attention(q, kc, vc, lens, starts)
    torch.cuda.synchronize()
    want = da.decode_attention_ref(q, kc, vc, lens, starts)
    err = float((got.float() - want.float()).abs().max())
    tol = attn_tol(dtype)
    ok = (torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
          and da.decode_attention.launches == n0 + 1
          and got.shape == q.shape and got.dtype == q.dtype)
    return err, ok


def decode_timing(da, gen, b, h, kh, t, dh, n, starts) -> dict:
    """One decode shape in bf16 with ``n`` valid slots of every row (ring
    starts: None or zeros), the caches as the model's views: the kernel
    timed against its bound, the plain version and PyTorch's fused
    attention on the valid prefix."""
    import torch
    f = lambda *shape: torch.randn(*shape, generator=gen, device="cuda") \
        .to(torch.bfloat16)
    q = f(b, h, dh)
    kc, vc = (f(b, t, kh, dh).transpose(1, 2) for _ in range(2))
    lens = torch.full((b,), n, dtype=torch.int32, device="cuda")
    st = None if starts is None else \
        torch.full((b,), starts, dtype=torch.int32, device="cuda")
    kernel_ms, times = median_ms(
        lambda: da.decode_attention(q, kc, vc, lens, st), reps=100)
    got = da.decode_attention(q, kc, vc, lens, st)
    out = {}
    plain_ms = cuda_ms(lambda: out.update(
        want=da.decode_attention_ref(q, kc, vc, lens, st)))
    err = float((got.float() - out["want"].float()).abs().max())
    q4 = q[:, :, None]
    kv, vv = (x[:, :, :n].contiguous() for x in (kc, vc))
    lib_ms, _ = median_ms(lambda: library_attention(q4, kv, vv, False),
                          reps=100)
    _, dev_ms, _ = device_busy(
        lambda: da.decode_attention(q, kc, vc, lens, st), 100)
    n_bytes = 2 * (2 * q.numel() + 2 * b * kh * n * dh)
    flops = 2 * 2 * b * h * n * dh
    bnd, by = bound(n_bytes, flops)
    print(f"decode_attention B={b} H={h} K={kh} T={t} length {n} starts "
          f"{starts} dh={dh} bf16: kernel {kernel_ms:.4f} ms/launch (of "
          f"{[round(x, 4) for x in times]}; on the card {dev_ms:.4f}), "
          f"plain {plain_ms:.3f} ms, "
          f"library {lib_ms:.4f} ms, bound {bnd:.6f} ms ({by}; "
          f"{n_bytes / 1e6:.2f} MB), {kh * b} blocks, max abs err "
          f"{err:.3g}", flush=True)
    if err > attn_tol(torch.bfloat16):
        raise AssertionError(f"decode_attention != plain at B={b} H={h} "
                             f"K={kh} T={t} dh={dh}")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "max_abs_err": err,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms}


def phase_decode(da) -> dict:
    """decode_attention == its plain version on the card over the sweep
    (prefix lengths, and ring starts where a local block's window drops
    slots of a wrapped ring), then the yi-6b and recurrentgemma-2b decode
    shapes timed against their bounds, the plain version and PyTorch's
    fused attention.  -> the yi-6b shape's numbers (the kernel
    table's)."""
    import torch
    from repro_torch.models import layers
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    n_bad = n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for h, kh, dh in DECODE_HEADS:
            for t in (512, 300):
                mix = [1, 257, 511, t, 64, 65, 2, t - 1]
                for lengths in ([1] * 8, [257] * 8, [min(511, t)] * 8,
                                [t] * 8, [min(x, t) for x in mix]):
                    err, ok = decode_case(da, gen, 8, h, kh, t, dh, dtype,
                                          lengths)
                    n_cases += 1
                    n_bad += not ok
                    if not ok:
                        print(f"decode_attention {dtype} H={h} K={kh} "
                              f"dh={dh} T={t} lengths={lengths}: max abs "
                              f"err {err:.3g} OVER TOLERANCE", flush=True)
    # A local block's ring: window 16 on 17 slots, every row at one
    # position (16: the first slot leaves the window; 17: the ring wraps;
    # 40) and a batch of rows at mixed positions (mixed starts).
    t, window = 17, 16
    for dtype in (torch.float32, torch.bfloat16):
        for h, kh, dh in ((10, 1, 256), (32, 4, 128), (8, 1, 64)):
            for last in ([16] * 8, [17] * 8, [40] * 8,
                         [0, 5, 16, 17, 18, 33, 40, 100]):
                runs = [layers.decode_run(torch.tensor(x), t, window)
                        for x in last]
                lengths = [int(n) for n, _ in runs]
                starts = [int(st) for _, st in runs]
                err, ok = decode_case(da, gen, 8, h, kh, t, dh, dtype,
                                      lengths, starts)
                n_cases += 1
                n_bad += not ok
                if not ok or dtype == torch.float32 and h == 10:
                    print(f"decode_attention ring T={t} window={window} "
                          f"{dtype} H={h} K={kh} dh={dh} positions {last} "
                          f"-> lengths {lengths} starts {starts}: max abs "
                          f"err {err:.3g} {'ok' if ok else 'OVER TOLERANCE'}",
                          flush=True)
    print(f"decode_attention sweep: {n_cases - n_bad}/{n_cases} cases "
          f"within tolerance (f32/bf16 x (H, K, dh) in {DECODE_HEADS} x T "
          f"512/300 x lengths 1, 257, 511, T and a mix per row; ring of 17 "
          f"slots, window 16, at positions 16, 17, 40 and a mix)",
          flush=True)
    if n_bad:
        raise AssertionError(f"decode_attention != plain in {n_bad} cases")
    b, t, n = SERVE_BATCH, 2 * SERVE_CHUNK, SERVE_CHUNK + 1
    yi = decode_timing(da, gen, b, 32, 4, t, 128, n, None)
    decode_timing(da, gen, b, 10, 1, t, 256, n, 0)
    return yi


def model_steps(lm, params, cfg, toks, n_decode, **kernels) -> tuple:
    """A prefill of SERVE_CHUNK tokens of every sequence, then
    ``n_decode`` decode steps; -> (logits [B, 1 + n_decode, V], the
    prefill's seconds, the mean decode step's seconds)."""
    import torch
    b, s = toks.shape[0], SERVE_CHUNK
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, cache = lm.prefill(params, cfg, {"tokens": toks[:, :s]},
                            lm.init_cache(cfg, b, 2 * s, "cuda"), **kernels)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    steps = [out]
    lengths = torch.full((b,), s, dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    for i in range(n_decode):
        out, cache, lengths = lm.decode_step(
            params, cfg, toks[:, s + i:s + i + 1], lengths, cache, **kernels)
        steps.append(out)
    torch.cuda.synchronize()
    return torch.cat(steps, dim=1), t_pre, \
        (time.perf_counter() - t0) / n_decode


def segment_timer(spent):
    """-> seg(name, fn): run ``fn`` between synchronisations and add its
    seconds to ``spent[name]``."""
    import torch

    def seg(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return r
    return seg


def cast_tree(tree, dtype):
    return {k: cast_tree(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def timed_attn_layer(layers, lp, x, cfg, cache, spent, *, lengths=None,
                     local=False):
    """One attention block, as ``layers.attn_block_prefill`` /
    ``attn_block_decode`` run it, cut into segments bracketed by
    synchronisations: the f32 -> bf16 weight casts, the attention
    projections (q, k, v with RoPE, and the output), attention (the cache
    write, the decode mask's run and the kernel), and the FFN (norm,
    gated FFN, residual).  Seconds add to ``spent``; -> (x, cache)."""
    import torch
    dtype = cfg.compute_dtype()
    seg = segment_timer(spent)
    pc = seg("casts", lambda: cast_tree(lp, dtype))
    b, s = x.shape[:2]
    window = cfg.local_window if local else 0
    positions = (lengths[:, None].to(torch.int32) if lengths is not None
                 else torch.arange(s, dtype=torch.int32,
                                   device=x.device)[None].expand(b, s))
    q, k, v = seg("attention projections", lambda: layers._qkv(
        pc, layers.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, positions,
        dtype))
    if lengths is None:
        new = seg("attention", lambda: {n: torch.cat(
            [t, cache[n][:, s:]], dim=1) for n, t in (("k", k), ("v", v))})
        out = seg("attention", lambda: layers.attention(
            q, k, v, causal=True, window=window, dtype=dtype))
    else:
        t_cache = cache["k"].shape[1]
        slot = torch.remainder(lengths[0].long(), t_cache)
        new = seg("attention", lambda: {n: cache[n].index_copy(
            1, slot.reshape(1), t) for n, t in (("k", k), ("v", v))})
        n, start = seg("attention", lambda: layers.decode_run(
            lengths[0].long(), t_cache, window))
        out = seg("attention", lambda: layers.decode_attention(
            q, new["k"], new["v"], n.expand(b),
            start.expand(b) if local else None, dtype=dtype))
    x = seg("attention projections", lambda: x + layers.ein(
        "bshk,hkd->bsd", out, pc["wo"], dtype=dtype))
    x = seg("ffn", lambda: x + layers.mlp_apply(
        pc["mlp"], layers.rms_norm(x, lp["ln2"], cfg.norm_eps),
        cfg.activation, dtype))
    return x, new


def timed_rglru_layer(rglru, layers, ops, lp, x, cfg, cache, spent, *,
                      decode):
    """One RG-LRU block, as ``rglru.rglru_block_prefill`` /
    ``rglru_block_decode`` run it, cut into segments bracketed by
    synchronisations: the f32 -> bf16 weight casts, the RG-LRU projections
    (norm, gate with GELU, input, output), the conv and gates, the
    ``rglru_scan`` kernel, and the FFN.  Seconds add to ``spent``; -> x."""
    dtype = cfg.compute_dtype()
    seg = segment_timer(spent)
    pc = seg("casts", lambda: cast_tree(
        {k: lp[k] for k in ("w_gate", "w_x", "w_out", "mlp")}, dtype))
    h = seg("rglru projections", lambda: layers.rms_norm(
        x, lp["ln1"], cfg.norm_eps))
    gate, u = seg("rglru projections", lambda: rglru._gate_and_input(
        pc, h, cfg))
    uc = seg("conv and gates", lambda: rglru._causal_conv(
        u, lp["conv_w"], lp["conv_b"], cache["conv"] if decode else None))
    a, bterm = seg("conv and gates", lambda: rglru._gates(lp, uc))
    hs = seg("rglru_scan", lambda: ops.rglru_scan(
        a, bterm, cache["h"] if decode else None))
    y = seg("rglru projections", lambda: layers.ein(
        "bsr,rd->bsd", hs.to(dtype) * gate, pc["w_out"], dtype=dtype))
    return seg("ffn", lambda: rglru._ffn(
        {"ln2": lp["ln2"], "mlp": pc["mlp"]}, x + y, cfg))


def device_busy(fn, n) -> tuple:
    """(wall ms, device ms, idle share) of one call of ``fn``: the card's
    kernel and copy time from ``torch.profiler`` over ``n`` calls (one
    stream, so the events do not overlap), against the wall time of ``n``
    more calls with the profiler off."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    return wall, busy, 1 - busy / wall


def phase_full_model(arch, n_want, counters, plain, time_layer):
    """``arch`` at its full config on the card: the parameter count, a
    prefill and 8 decode steps through the kernels and through the plain
    versions (``plain``, passed by name; logits held together), then where
    a prefill's and a decode step's time goes (``time_layer(kind, lp, x,
    cfg, cache, spent, lengths) -> x`` runs one block cut into segments)
    and how much of each the card is busy.  ``counters`` name the kernel
    wrappers whose launches each path prints.  -> the parameters."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm
    cfg = registry.get(arch)[0]
    n = lm.n_params(cfg)
    if n != n_want or cfg.dtype != "bfloat16":
        raise AssertionError(f"{arch}: {n} parameters in {cfg.dtype}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    print(f"{arch}: {n} parameters ({cfg.param_dtype} at rest, {cfg.dtype} "
          f"compute), init {time.perf_counter() - t0:.3f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    b, s, nd = SERVE_BATCH, SERVE_CHUNK, 8
    toks = torch.randint(0, cfg.vocab, (b, s + nd), generator=gen,
                         device="cuda")
    model_steps(lm, params, cfg, toks, 1)                       # warm
    logits, times = {}, {}
    for path, kernels in (("kernel", {}), ("plain", plain)):
        n0 = {k: f.launches for k, f in counters.items()}
        logits[path], t_pre, t_dec = model_steps(lm, params, cfg, toks, nd,
                                                 **kernels)
        times[path] = (t_pre, t_dec)
        print(f"model {arch} {path} path: prefill {b} x {s} tokens "
              f"{t_pre * 1e3:.2f} ms, decode step {t_dec * 1e3:.2f} ms "
              f"(mean of {nd}); launches "
              + ", ".join(f"{k} {f.launches - n0[k]}"
                          for k, f in counters.items()), flush=True)
    a, w = logits["kernel"], logits["plain"]
    err = float((a - w).abs().max())
    mean = float((a - w).abs().mean())
    tol = MODEL_LOGITS_TOL * float(w.abs().max())
    ok = bool(torch.isfinite(a).all()) and a.shape == (b, 1 + nd, cfg.vocab) \
        and err <= tol
    print(f"model {arch} kernel vs plain logits over {1 + nd} steps: max "
          f"abs diff {err:.4g} (mean {mean:.3g}, largest logit "
          f"{float(w.abs().max()):.4g}), tolerance {tol:.4g} "
          f"({MODEL_LOGITS_TOL:.0%} of the largest): "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError(f"{arch} logits: kernel path != plain path")
    # Where a prefill's and a decode step's time goes.
    p = params.tree()
    for name in ("prefill", "decode"):
        spent = {}
        decode = name == "decode"
        x = lm._embed_tokens(p, cfg, toks[:, s:s + 1] if decode
                             else toks[:, :s])
        cache = lm._layer_caches(lm.init_cache(cfg, b, 2 * s, "cuda"), cfg)
        lengths = torch.full((b,), s, dtype=torch.int32, device="cuda") \
            if decode else None
        for (kind, lp), lc in zip(lm._layers(p, cfg), cache):
            x = time_layer(kind, lp, x, cfg, lc, spent, lengths)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm._unembed(p, cfg, x[:, -1:])
        torch.cuda.synchronize()
        spent["unembed"] = time.perf_counter() - t0
        tot = sum(spent.values())
        print(f"{arch} one {name}, {cfg.n_layers} blocks cut by "
              f"synchronisations ({tot * 1e3:.2f} ms in all; uncut "
              f"{times['kernel'][decode] * 1e3:.2f} ms): "
              + ", ".join(f"{k} {v * 1e3:.2f} ms ({v / tot:.1%})"
                          for k, v in spent.items()), flush=True)
    # How much of a step the card is busy.
    _, cache = lm.prefill(params, cfg, {"tokens": toks[:, :s]},
                          lm.init_cache(cfg, b, 2 * s, "cuda"))
    lengths = torch.full((b,), s, dtype=torch.int32, device="cuda")
    for name, fn, k in (
            ("prefill", lambda: lm.prefill(
                params, cfg, {"tokens": toks[:, :s]},
                lm.init_cache(cfg, b, 2 * s, "cuda")), 2),
            ("decode step", lambda: lm.decode_step(
                params, cfg, toks[:, s:s + 1], lengths, cache), 3)):
        wall, busy, idle = device_busy(fn, k)
        print(f"{arch} one {name}: {wall:.2f} ms wall, {busy:.2f} ms of "
              f"kernels and copies on the card (torch.profiler, mean of "
              f"{k}), device idle share {idle:.1%}", flush=True)
    print(f"{arch} model phase: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return params


def phase_yi_model(fa, da):
    """yi-6b at its full config on the card (:func:`phase_full_model`),
    each attention block cut into casts, projections, attention and FFN.
    -> the parameters, for the serve phase."""
    from repro_torch.models import layers

    def time_layer(kind, lp, x, cfg, cache, spent, lengths):
        return timed_attn_layer(layers, lp, x, cfg, cache, spent,
                                lengths=lengths)[0]
    return phase_full_model(
        YI, YI_PARAMS, {"flash_attention": fa.flash_attention,
                        "decode_attention": da.decode_attention},
        dict(flash_attention=fa.flash_attention_ref,
             decode_attention=da.decode_attention_ref), time_layer)


def phase_serve_once(arch, counters, params, *, with_decode) -> tuple:
    """``arch``'s serving path: calibrate once on the card, then asl, fifo
    and greedy answer one Poisson stream on that cost model for
    SERVE_DURATION_S, with a TTFT SLO of 4 x the mean prompt's prefill.
    The rate puts half of the slot on the mean request: its prompt's
    prefill chunks, and (``with_decode``) its mean new tokens decoded at
    batch 1.  The kernel counters are set to 0 just before and read just
    after.  -> (launches, rate, SLO)."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = registry.get(arch)[0]
    for f in counters.values():
        f.launches = 0
    cost = serve.calibrated_cost(cfg, batch=SERVE_BATCH,
                                 prefill_chunk=SERVE_CHUNK, device="cuda",
                                 params=params)
    chunks = sum(-(-n // SERVE_CHUNK) for n in serve.PROMPT_LENS) \
        / len(serve.PROMPT_LENS)
    new = sum(serve.NEW_TOKENS) / len(serve.NEW_TOKENS) if with_decode \
        else 0
    busy = chunks * cost.prefill_chunk_s + new * cost.decode_step_s
    rate = 0.5 / busy
    slo = 4 * chunks * cost.prefill_chunk_s
    runs = {sched: serve.serve(cost, sched, rate=rate,
                               duration=SERVE_DURATION_S, slo_ttft=slo)
            for sched in SCHEDULERS}
    launches = {k: f.launches for k, f in counters.items()}
    print(f"serve {arch}: calibrated prefill chunk "
          f"{cost.prefill_chunk_s * 1e3:.2f} ms, decode step "
          f"{cost.decode_step_s * 1e3:.2f} ms; Poisson {rate:.4f} "
          f"requests/s (0.5 / ({chunks:.3f} chunks x prefill chunk + "
          f"{new:.0f} x decode step = {busy:.3f} s)) for "
          f"{SERVE_DURATION_S:.0f} s, TTFT SLO {slo:.3f} s", flush=True)
    check_serve_runs(arch, lm.n_params(cfg), cfg.dtype,
                     {"decode_step_s": cost.decode_step_s,
                      "prefill_chunk_s": cost.prefill_chunk_s}, runs)
    print(f"serve {arch}: launches {launches} (one calibration: 6 "
          f"prefills and 21 decode steps of {cfg.n_layers} layers)",
          flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"the {arch} serving path launched a kernel "
                             f"no time: {launches}")
    return launches, rate, slo


def phase_yi_cli(rate, slo) -> None:
    """``python -m repro_torch.launch.serve --arch yi-6b`` once, in its own
    process, at the serve phase's rate and SLO: it calibrates on the card
    and prints each scheduler's row."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "yi-6b", "--rate", f"{rate:.6f}", "--duration",
           f"{SERVE_DURATION_S:.0f}", "--slo-ttft", f"{slo:.6f}",
           "--scheduler", *SCHEDULERS]
    print("$ " + " ".join(cmd[1:]), flush=True)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ,
                                           "PYTHONPATH": str(ROOT / "src")})
    for line in res.stdout.splitlines():
        print(f"  {line}")
    print(f"  (exit {res.returncode} in {time.perf_counter() - t0:.1f} s)",
          flush=True)
    if res.returncode != 0 or res.stdout.count("scheduler=") != 3:
        print(res.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"the {YI} serve CLI failed")


# ---------------------------------------------------------------------------
# recurrentgemma-2b: rglru_scan, the model and its server
# ---------------------------------------------------------------------------

def rglru_inputs(gen, b, s, r, dtype, h0) -> tuple:
    """a = sigmoid(normal) in (0, 1), as the model makes it, and x normal,
    both in ``dtype``; h0 normal f32 or None; all on the card."""
    import torch
    f = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    a = torch.sigmoid(f(b, s, r)).to(dtype)
    return a, f(b, s, r).to(dtype), f(b, r) if h0 else None


def rglru_check(got, want, dtype) -> tuple:
    """(max abs error, within RGLRU_TOL: bit for bit in f32)."""
    import torch
    err = float((got.float() - want.float()).abs().max())
    tol = RGLRU_TOL[str(dtype).replace("torch.", "")]
    ok = got.dtype == want.dtype and got.shape == want.shape and (
        torch.equal(got, want) if tol == 0 else
        torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
    return err, ok


def rglru_bound(b, s, r, esize, h0) -> tuple:
    """Least time of one scan: a and x read once and every h_t written
    once (in their type), h0 read once; 2 f32 operations per element over
    the non-tensor f32 rate."""
    n_bytes = 3 * b * s * r * esize + (4 * b * r if h0 else 0)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * b * s * r / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def phase_rglru(rs) -> dict:
    """rglru_scan == its plain version on the card over the listed cases
    (bit for bit in f32: h, and so the last carry h[:, -1]), then one
    launch at the serving shape timed against its bound."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    n_bad = n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for s in (1, 7, 256):
            for r in (2560, 100):
                for h0 in (False, True):
                    a, x, h = rglru_inputs(gen, 2, s, r, dtype, h0)
                    n0 = rs.rglru_scan.launches
                    got = rs.rglru_scan(a, x, h)
                    torch.cuda.synchronize()
                    err, ok = rglru_check(got, rs.rglru_scan_ref(a, x, h),
                                          dtype)
                    ok = ok and rs.rglru_scan.launches == n0 + 1
                    n_cases += 1
                    n_bad += not ok
                    print(f"rglru_scan {dtype} B=2 S={s} R={r} h0={h0}: "
                          f"max abs err {err:.3g} "
                          f"{'ok' if ok else 'OVER TOLERANCE'}", flush=True)
    print(f"rglru_scan sweep: {n_cases - n_bad}/{n_cases} cases within "
          f"tolerance (f32 bit for bit, bf16 within "
          f"{RGLRU_TOL['bfloat16']})", flush=True)
    if n_bad:
        raise AssertionError(f"rglru_scan != plain in {n_bad} cases")
    # The serving shape: a prefill chunk of the calibration, as the model
    # calls the kernel (f32 a and x, no h0).
    b, s, r = SERVE_BATCH, SERVE_CHUNK, 2560
    a, x, _ = rglru_inputs(gen, b, s, r, torch.float32, False)
    kernel_ms, times = median_ms(lambda: rs.rglru_scan(a, x), reps=100)
    _, dev_ms, _ = device_busy(lambda: rs.rglru_scan(a, x), 100)
    got = rs.rglru_scan(a, x)
    out = {}
    plain_ms = cuda_ms(lambda: out.update(want=rs.rglru_scan_ref(a, x)))
    err, ok = rglru_check(got, out["want"], torch.float32)
    bnd, by = rglru_bound(b, s, r, 4, False)
    print(f"rglru_scan serving shape B={b} S={s} R={r} f32: kernel "
          f"{kernel_ms:.4f} ms/launch (of {[round(t, 4) for t in times]}; "
          f"on the card {dev_ms:.4f}), plain {plain_ms:.2f} ms, bound "
          f"{bnd:.5f} ms ({by}), max abs err {err:.3g}", flush=True)
    if not ok:
        raise AssertionError("rglru_scan != plain at the serving shape")
    # The decode shape: one step from a carry.
    a1, x1, h1 = rglru_inputs(gen, b, 1, r, torch.float32, True)
    dec_ms, _ = median_ms(lambda: rs.rglru_scan(a1, x1, h1), reps=100)
    _, dec_dev_ms, _ = device_busy(lambda: rs.rglru_scan(a1, x1, h1), 100)
    err1, ok1 = rglru_check(rs.rglru_scan(a1, x1, h1),
                            rs.rglru_scan_ref(a1, x1, h1), torch.float32)
    print(f"rglru_scan decode shape B={b} S=1 R={r} with h0: kernel "
          f"{dec_ms:.4f} ms/launch (on the card {dec_dev_ms:.4f}), bound "
          f"{rglru_bound(b, 1, r, 4, True)[0]:.6f} ms, max abs err "
          f"{err1:.3g}", flush=True)
    if not ok1:
        raise AssertionError("rglru_scan != plain at the decode shape")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "max_abs_err": err,
            "bound_ms": bnd, "bound_by": by}


def phase_rg_model(rs, fa, da):
    """recurrentgemma-2b at its full config on the card
    (:func:`phase_full_model`), each RG-LRU block cut into casts, RG-LRU
    projections, conv and gates, ``rglru_scan`` and FFN, and each local
    attention block into casts, projections, attention and FFN.  -> the
    parameters, for the serve phase."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers, rglru

    def time_layer(kind, lp, x, cfg, cache, spent, lengths):
        if kind == "rglru":
            return timed_rglru_layer(rglru, layers, ops, lp, x, cfg, cache,
                                     spent, decode=lengths is not None)
        return timed_attn_layer(layers, lp, x, cfg, cache, spent,
                                lengths=lengths, local=True)[0]
    return phase_full_model(
        RG, RG_PARAMS, {"rglru_scan": rs.rglru_scan,
                        "flash_attention": fa.flash_attention,
                        "decode_attention": da.decode_attention},
        dict(rglru_scan=rs.rglru_scan_ref,
             flash_attention=fa.flash_attention_ref,
             decode_attention=da.decode_attention_ref), time_layer)


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
        from repro_torch.kernels import mlstm_scan as ms
        from repro_torch.kernels import decode_attention as da
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import rglru_scan as rs
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
            entry = ""
            for line in log.splitlines():
                if "Compiling entry" in line:
                    entry = instantiation(line)
                elif "registers" in line or "spill" in line:
                    print(f"  {name} {entry}: {line.strip()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_parity(sl, simstep)
        shape = phase_main_shape(sl, simstep)
        main_run = phase_main(sl, simstep)
        mlstm = phase_mlstm(ms)
        serve_run = phase_serve(ms)
        phase_model(ms)
        flash = phase_flash(fa)
        dec = phase_decode(da)
        params = phase_yi_model(fa, da)
        yi_launches, rate, slo = phase_serve_once(
            YI, {"flash_attention": fa.flash_attention,
                 "decode_attention": da.decode_attention}, params,
            with_decode=False)
        del params
        torch.cuda.empty_cache()
        phase_yi_cli(rate, slo)
        rglru = phase_rglru(rs)
        params = phase_rg_model(rs, fa, da)
        rg_launches, _, _ = phase_serve_once(
            RG, {"rglru_scan": rs.rglru_scan,
                 "flash_attention": fa.flash_attention,
                 "decode_attention": da.decode_attention}, params,
            with_decode=True)
        del params
        torch.cuda.empty_cache()
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
        library_ms=None), dict(
        name="mlstm_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/mlstm_scan.cu",
        replaces="src/repro/kernels/mlstm_scan.py:68",
        launches=serve_run["launches"], max_abs_err=mlstm["max_abs_err"],
        ms=mlstm["ms"], plain_ms=mlstm["plain_ms"],
        bound_ms=mlstm["bound_ms"], bound_by=mlstm["bound_by"],
        library_ms=None), dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:43",
        launches=rg_launches["rglru_scan"], max_abs_err=rglru["max_abs_err"],
        ms=rglru["ms"], plain_ms=rglru["plain_ms"],
        bound_ms=rglru["bound_ms"], bound_by=rglru["bound_by"],
        library_ms=None)] + [dict(
        name=name, route="cuda",
        source=f"src/repro_torch/kernels/csrc/{name}.cu", replaces=where,
        launches=yi_launches[name], max_abs_err=r["max_abs_err"],
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"])
        for name, where, r in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:94",
             flash),
            ("decode_attention", "src/repro/kernels/decode_attention.py:70",
             dec))]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
