#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, no result line):

1. Print the card (``nvidia-smi``) and build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` (one process per
   source, ``simstep.cu`` one per instantiation group, all started
   together); ``fused_chunk`` must keep no stack frame in any
   instantiation (``ptxas -v``; each policy's and the merged set's,
   deterministic and stochastic).
2. Hold the ``fused_chunk`` kernel against its plain PyTorch version on
   the card, bit for bit in every state leaf: each of the seven policies
   on the fig1 and Bench-1 programs over a small grid; each again on the
   Bench-1 program with long epochs, the wakeup cost and the energy model
   on; the seven as one merged set (a ``policy`` axis) with the same
   features; chunk 1 against chunk 128.  These comparisons, and those
   of 3c and 3d below, run first, spread over ``PLAIN_WORKERS`` (4)
   processes on the one card (``run_plain_jobs``): the plain step is
   thousands of small launches a step, bound by the host.  Then one
   launch at the main path's shapes (timed, with its bound).
3. Drive the main path at full size through ``sweep``'s two parts,
   ``init_sweep`` and ``simulate``: the paper's fig1 calibration for
   60,000 us, one sweep per policy (2,120 cells), with the kernel launch
   counters set to 0 just before and read just after.  Every cell must
   retire events, the n_cores=8 summaries must be finite, and the
   n_cores=8 (seed 0) cells must equal the JAX package's final state bit
   for bit (``REFERENCE_DIGESTS``).  Each sweep's wall time split into
   ``init_sweep`` and ``simulate``, its events/s, its launches past the
   last live chunk, and ``simulate``'s time on the card in the kernel
   (profiler) and outside it.
3b. The paper's other figure grids at full length through ``sweep``, with
   the ``fused_chunk`` counter set to 0 just before and read just after:
   Bench-1 (both phases of ``bench1_contended``, one merged 4-policy
   set), Bench-3 (long epochs, 120,000 us), Bench-5 (the
   ``seg_noncrit_us`` table axis), Bench-6 (the wakeup cost), fig1 for
   edf, shfl and dvfs_race, and ``energy_efficiency`` over the seven
   policies (the ``big``, speed and power table axes zipped).  Each
   grid's final state must equal the JAX package's bit for bit
   (``FIGURE_DIGESTS``), every cell retire events and its summary be
   finite (with the energy keys where watts are modeled).  Each grid's
   wall time, events/s, launches, ms a launch on the card (profiler) and
   bound.
3c. The paper's load, excess-tail and chaos figures (``paper_figs``'
   ``loadlat_sweep``, 168 cells; ``openloop_loadlat``, 108;
   ``excess_tail``, 18; ``chaos_collapse``, the seven ported policies x
   5 preemption rates) through the kernel's stochastic instantiations.
   First a cut of each (a few cells, 4,000 us; chaos on fifo and libasl)
   and a features cut (the seven policies merged, MMPP, the four
   service distributions, churn, straggling, preemption, histograms):
   the kernel against the plain step on the card, every leaf, and the
   kernel's final state equal to the JAX package's (``CUT_DIGESTS``).
   A diurnal cut (fifo and libasl merged, 2,000 us; its sine at parity
   level 3, so no JAX digest) is held to the plain step alone.
   Then the full grids at full length through ``sweep``, with the
   ``fused_chunk`` counter set to 0 just before and read just after,
   each final state equal to the JAX package's (``FIGURE_DIGESTS``);
   each grid's cells, events, wall time, events/s, launches, ms a launch
   on the card and bound, and the figure's own columns (throughput and
   epoch P99 a row; the excess of the histogram P99 / P999 over the SLO;
   goodput and its SLO fraction).
3d. The keyshard figure (``paper_figs.keyshard``: fifo, ks_erew, ks_crew,
   ks_jbsq, 9 cells each, 4,096 Zipf keys) at full length through
   ``sweep``'s two parts, each grid held to the JAX package's final
   state, after its keyed cuts and each ``ks_*`` policy with keys off,
   kernel against plain step.
3e. The six closed-loop figures of ``paper_figs`` at full length through
   ``sweep``'s two parts, with the ``fused_chunk`` counter set to 0 just
   before and read just after: ``fig1_collapse`` for the seven
   registered policies 3b does not run, ``fig4_big_affinity``,
   ``fig5_proportional``, ``bench1_slo_sweep``, ``bench4_scalability``
   (fifo, tas, then the zipped 24-cell libasl grid whose SLOs come from
   the tas rows) and ``bench2_variable``'s four ``run`` calls with the
   windows carried.  Each grid's (each run's) final state must equal the
   JAX package's (``FIGURE_DIGESTS``); its cells, events, wall time,
   events/s, launches and ms a launch on the card.
3f. The simulator's API on the card, the counter set to 0 just before
   and read just after: Bench-4's libasl grid and the loadlat cut swept
   one-shot (held to their JAX digests), resumable in slices of 7 and 64
   cells (the last slices' checkpoints deleted and resumed) and split
   over 2, 3 and 4 x ``cuda:0``, each bit-equal to the one-shot sweep; a
   resume directory of another sweep refused; ``sweep_slo`` over Figure
   8b's seven SLOs and the ``amp_config`` multi-tenant grid held to their
   JAX digests; fig1's registered policies one executable each; the
   phase's ``sweep_log()`` and ``executable_records()``.
3g. ``examples/lock_microbench_torch.py`` once, in its own process: exit
   0, its six tables and its ``fused_chunk`` launches.
3h. ``examples/serving_bench_torch.py``'s four sections (the fleet
   dispatcher under every dispatch policy across its load sweep, the
   serving engine's two sections and the staleness simulation; host-side
   numpy) at ``SCALE = 1.0``, each section's rows held to the JAX
   package's (``FLEET_DIGESTS``).
4. Hold the ``mlstm_scan`` kernel against its plain PyTorch version on
   the card: f32 and bf16 inputs, with and without a carry, S in {1, 7,
   15, 16, 17, 256} (the ring's 16-step chunks' edges), dh in {32, 192},
   q, k, v and the gates as [B,H,S,*] tensors and as the model's
   transposed [B,S,H,*] views; h, C, n and m within the JAX package's
   kernel bar (``tests/test_kernels.py``: 10 x TOL on h, 1e-4 on C and n,
   1e-5 on m), two calls bit-equal.  Print the launch plan (blocks at
   both serving shapes) and fail on any spill ``ptxas`` reports.  Time
   the serving prefill and decode shapes (wall and card) beside their
   bounds.
5. Serve xlstm-125m at its full config (130,425,648 parameters, bf16)
   through ``repro_torch.launch.serve.main``: one calibration, then the
   asl, fifo and greedy schedulers on that cost model, with the
   ``mlstm_scan`` launch counters set to 0 just before and read just
   after (prefill and decode launches apart).
6. The full-width xLSTM model against its plain path on the card:
   prefill 256 tokens then 8 decode steps through the kernel and through
   the plain version; logits within 10 x TOL[bf16] = 0.2.  Then where a
   prefill's and a decode step's time goes, block by block.
7. Hold ``flash_attention`` against its plain version on the card (f32
   and bf16, head dims 64, 128 and 256, GQA groups 1 and 8 and recurrentgemma's
   10 q heads on 1 kv head, ragged S and T, among them the edges of the
   tensor-core route's 64-row tiles, 63/65, 64/129, 129/64 and 1/4096,
   causal or not, window 0 or 64) within the JAX package's kernel bar
   (TOL), every bf16 case on the tensor-core route and every f32 case on
   the f32 kernel; then time it at the yi-6b and recurrentgemma-2b
   prefill shapes beside its bound, the plain version, PyTorch's fused
   attention and the f32-pipe kernel's earlier time.
8. The same for ``decode_attention``, each case through the wrapper's
   split over the cache and through one forced split (per-row lengths
   1, 257, 511, T, a mix, 0 and the split edges 15, 16, 17, 63, 64, 65;
   T of 512 and 300; runs that wrap at T inside a split; a local block's
   ring of 17 slots with window 16 at positions 16, 17, 40 and a mix;
   recurrentgemma-2b's heads on its ring of 2,049 slots), rows of length
   0 zeros; timed at the yi-6b and recurrentgemma-2b decode shapes (at
   least one block per SM, two calls bit-equal), the split against the
   unsplit kernel in turns.
9. yi-6b at its full config (6,061,035,520 parameters, f32 at rest, bf16
   compute): a prefill of 8 x 256 tokens and 8 decode steps through the
   kernels and through the plain versions, logits within 3 % of the
   largest; then a prefill's and a decode step's time split into the
   weight casts, projections, attention and FFN, and the card's busy
   time in each from ``torch.profiler`` (the device idle share).
10. Serve yi-6b: one calibration, then asl, fifo and greedy on that cost
    model at a rate that puts half of the slot on prefill, TTFT SLO 4 x
    the mean prompt's prefill, with both attention counters set to 0
    just before and read just after (every ``flash_attention`` launch on
    the tensor-core route, some ``decode_attention`` calls split over the
    cache); then the
    ``python -m repro_torch.launch.serve --arch yi-6b`` CLI once at that
    rate, in its own process.  The yi-6b weights are freed.
11. Hold ``rglru_scan`` against its plain version on the card, bit for
    bit in f32 and bf16: with and without h0, S in {1, 7, 63, 64, 65,
    197, 256} (the ring's 64-step chunks' edges), R in {2560, 100, 17}
    (rows that do not start on 16 bytes among them), a in (0, 1), two
    calls bit-equal; print the launch plans (blocks, channels, stages);
    time the serving prefill, decode and training shapes (wall and card)
    beside their bounds and the plain version, and 16 against 32
    channels a block.
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
    after (every ``flash_attention`` launch on the tensor-core route, some
    ``decode_attention`` calls split over the cache).
13b. ``flash_attention`` and ``decode_attention`` at gemma-7b's shapes
    (16 q heads on 16 kv heads of 256, bf16): a causal unwindowed prefill
    of 256 tokens and its ragged edges, a decode over the full 512-slot
    cache at lengths 0 to 512, split and unsplit, each against its plain
    version; both timed at the serving shapes beside their bounds, the
    plain versions and PyTorch's fused attention.
13c. gemma-7b at its full config (8,537,680,896 parameters, f32 at rest,
    bf16 compute, its residual stream f32 from the scaled embedding on):
    a prefill of 8 x 256 tokens and 8 decode steps through the kernels
    and through the plain versions, logits within 3 % of the largest; a
    prefill's and a decode step's time split into casts, projections,
    attention and FFN; the device idle share.
13d. Serve gemma-7b: one calibration, then asl, fifo and greedy on that
    cost model at a rate set from both calibrated costs, with both
    attention counters set to 0 just before and read just after.  The
    gemma-7b weights are freed.
13e-13h. phi3.5-moe-42b, grok-1-314b, llama3-405b and qwen1.5-110b, each
    at every published width with its layers cut to fit one card (16, 4,
    6 and 16 layers; ``CUT_MODELS``; bf16 at rest and in compute), one
    after another, each one's weights freed before the next: both
    attention kernels at its shapes (GQA groups 4, 6, 16 and 8 at head
    dim 128, causal, unwindowed), as in 13b; the cut model as in 13c, its
    mixture-of-experts blocks (phi3.5-moe, grok-1) cut into routing,
    expert products and combine, with the (token, layer, choice) expert
    ids that differ between the kernel and the plain path counted, and
    the plain path run again with the kernel path's expert choices; and
    served as in 13d.
13i. llava-next-mistral-7b at its full config (7,241,732,096 parameters,
    f32 at rest, bf16 compute; the ``vision_stub`` frontend): both
    attention kernels at its shapes (32 q heads on 8 kv heads of 128), a
    causal prefill of 3,008 positions and its ragged edges, a decode over
    the 4,096-slot cache at lengths up to 3,016, split and unsplit, each
    against its plain version and timed beside its bound, the plain
    version and PyTorch's fused attention; then the model through
    ``lm.prefill`` (8 prompts of 2,880 patch embeddings and 128 tokens)
    and 8 ``lm.decode_step``s, kernel path against plain path (logits
    within 3 % of the largest; every ``flash_attention`` launch on the
    tensor-core route, every ``decode_attention`` call split); a
    prefill's and a decode step's time split into casts, projections,
    attention, FFN and unembedding; the device idle share and peak
    memory.  The weights are freed.
13j. hubert-xlarge at its full config (944,487,680 parameters; the
    ``audio_stub`` frontend, encoder-only): ``flash_attention`` at head
    dim 80, bidirectional, f32 and bf16, S/T of 1/1, 63/65, 77/300,
    1,000/1,000 and 4,096/4,096 (``DH80_LENGTHS``), each against its
    plain version (3e-5, 2e-2) and timed beside its bound, the plain
    version and PyTorch's fused attention; a dh-80 ``flash_attention_bwd``
    and ``decode_attention`` call must raise; then ``lm.forward`` of 8 x
    1,000 frames, kernel path against plain path (3 %; 48 tensor-core
    launches), its time split as in 13i, idle share and peak memory.
14. Hold ``flash_attention``'s log-sum-exp rows (the training forward's
    second output) and ``flash_attention_bwd`` against their plain
    versions on the card: f32 and bf16, head dims 32, 64, 128 and 256,
    (H, K) of (4, 4), (32, 4) and (10, 1), S and T of 1/1, 77/300,
    256/256 and 300/77 and the tile edges 63/65, 64/129, 129/64 and
    1/4096, causal or not, window 0 or 64, each dtype on its route; the
    rows within
    1e-4 (+inf where no key is visible), the forward without them
    unchanged bit for bit, dq, dk and dv within the JAX package's bar
    (``tests/test_kernels_bwd.py``: 5e-5 f32, 5e-2 bf16).  At the
    recurrentgemma-2b and yi-6b training shapes (B=1, S=T=4096, bf16) the
    forward's output (TOL), its rows (1e-4) and dq, dk and dv (5e-2)
    against the plain versions element by element, out, dq, dk and dv
    also by relative error ||a - w|| / ||w|| (1 %; planted faults must
    read above it), and two backward calls on the same inputs bit-equal;
    one backward call and one forward with its rows timed beside their
    bounds, the plain versions, PyTorch's fused attention and the
    profiler's kernel time, and the f32-pipe kernels' earlier times; the
    backward's dk/dv split, where the wrapper takes one, timed against
    none.
15. Hold the ``rglru_scan`` backward (one launch walking time in
    reverse) against the plain reverse loop, bit for bit in f32 and bf16
    (da, dx, dh0): with and without h0, S in {1, 7, 63, 64, 65, 197,
    4096}, R in {2560, 100, 17}, one launch of its own counter a call;
    time it at the training shape (wall and card) beside its bound.
16. One loss-and-grad at recurrentgemma-2b's full widths cut to 3 layers,
    one [1, 4096] microbatch, kernel path against plain path: the loss
    within 0.5 %, each block kind's gradients within 3 % of their largest
    magnitude.
17. Train recurrentgemma-2b at its full config through
    ``repro_torch.launch.train.main`` (3 steps of 2 x 4096 tokens in 2
    microbatches), with the ``flash_attention``, ``flash_attention_bwd``
    ``rglru_scan`` and ``rglru_scan_bwd`` counters set to 0 just before
    and read just after; each must be 3 x its launches per step (32, 16,
    72 and 36), every
    attention launch on the tensor-core route, and no incoming gradient
    copied before ``flash_attention_bwd``.  Finite
    losses and grad norms; the step time, tokens/s, MFU and peak memory.
18. The trainer's final checkpoint (31.9 GB of params, m and v, in a
    temporary directory removed at the end) restored into a fresh
    ``Trainer``: every leaf equal bit for bit, ``latest()`` the step; the
    seconds to write (the trainer's own ``ckpt_s``) and to read.
19. One more step of the trainer's step function under ``torch.profiler``:
    its card time split by the port's ``repro_torch.*`` ranges into
    forward, recompute, attention backward, scan backward, the rest of
    the backward and the optimizer; against the wall time of one more
    step, the device idle share.
20. Print each phase's wall time, the kernel table (JSON), the card and,
    last, the device line.

Card times come from ``torch.profiler`` traces; one that holds fewer
kernels and copies on the card than were launched is taken again, and
a time with no complete trace is printed as "not measured" and written
as null, never as 0.

It exits non-zero when no CUDA device is present, and when the port's
package is not next to it.
"""

from __future__ import annotations

import contextlib
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
F32_OPS_PER_S = 67e12       # H100 SXM f32 rate outside the tensor cores

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
# (tests/test_kernels.py: TOL, absolute and relative), rglru_scan and its
# backward to their plain versions bit for bit in f32 and bf16 (the carry
# and the gradient stay f32, rounded only where stored); the models' logits, kernel path against plain path, to 3 %
# of the largest logit (the bar tests/test_torch_yi.py and
# tests/test_torch_recurrentgemma.py hold the models to against JAX in
# bf16).
YI = "yi-6b"
YI_PARAMS = 6_061_035_520
RG = "recurrentgemma-2b"
RG_PARAMS = 2_658_736_640
GEMMA = "gemma-7b"
GEMMA_PARAMS = 8_537_680_896
# The architectures that do not fit one card at full depth, served at
# every published width (d_model, heads, head dim, d_ff, experts, top-k,
# vocab) with their layers cut to 39-46 GiB of bf16 weights, near
# gemma-7b's 43.4 GiB peak: arch -> (layers at the cut, parameters at the
# cut, layers and parameters at full depth).
CUT_MODELS = {
    "phi35-moe-42b": (16, 21_067_599_872, 32, 41_872_527_360),
    "grok-1-314b": (4, 21_290_539_008, 64, 316_489_340_928),
    "llama3-405b": (6, 23_328_931_840, 126, 405_853_388_800),
    "qwen15-110b": (16, 24_235_122_688, 80, 111_209_914_368),
}
# The two frontend models at their full configs (f32 at rest, bf16
# compute), through lm's model functions (neither serves: the reference's
# serve CLI feeds llava tokens only and refuses the encoder-only hubert).
# llava-next-mistral-7b (hf:llava-hf/llava-v1.6-mistral-7b-hf): 8 prompts
# of the config's 2,880 patch embeddings (base 576 + 4 anyres tiles x 576)
# and 128 text tokens, 3,008 positions into a 4,096-slot cache, then 8
# decode steps.  hubert-xlarge (arXiv:2106.07447): an encoder forward of 8
# utterances of 1,000 frames (20 s of 16 kHz audio at 50 frames/s; the
# last 64-row tile ragged), bidirectional attention at head dim 80.
LLAVA = "llava-next-mistral-7b"
LLAVA_PARAMS = 7_241_732_096
LLAVA_TEXT, LLAVA_CACHE = 128, 4096
HUBERT = "hubert-xlarge"
HUBERT_PARAMS = 944_487_680
HUBERT_FRAMES = 1000
FRONTEND_DECODE = 8
# S/T of phase 13j's dh-80 flash_attention checks (batch 8 at the model's
# 1,000 frames, else 2).
DH80_LENGTHS = ((1, 1), (63, 65), (77, 300), (1000, 1000), (4096, 4096))
SERVE_DURATION_S = 600.0
MODEL_LOGITS_TOL = 0.03
ATTN_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
RGLRU_TOL = {"float32": 0.0, "bfloat16": 0.0}

# The training path: recurrentgemma-2b at its full config, 3 steps of a
# global batch of 2 x 4096 tokens in 2 microbatches (each [1, 4096], so
# the 2048-token window masks half of every long row), f32 parameters and
# AdamW moments, bf16 compute.  flash_attention_bwd is held to the JAX
# package's bar for it (tests/test_kernels_bwd.py: 5e-5 f32, 5e-2 bf16,
# absolute and relative), the scan's backward to its plain version bit for
# bit; one full-width step's loss, kernel path against plain path,
# to 0.5 % and each block kind's gradients to 3 % of their largest
# magnitude (the bf16 bar the models' logits are held to).
TRAIN_SEQ = 4096
TRAIN_BATCH = 2
TRAIN_MICROBATCHES = 2
TRAIN_STEPS = 3
TRAIN_ARGS = ["--arch", "recurrentgemma-2b", "--steps", str(TRAIN_STEPS),
              "--global-batch", str(TRAIN_BATCH), "--seq-len",
              str(TRAIN_SEQ), "--microbatches", str(TRAIN_MICROBATCHES),
              "--ckpt-every", "1000"]
FLASH_BWD_TOL = {"float32": 5e-5, "bfloat16": 5e-2}
# At the training shapes a typical |dq| or |out| is a few hundredths, the
# size of the element-by-element bars, so each of out, dq, dk and dv is
# also held to its relative error ||a - w|| / ||w|| against the plain
# version: bf16 rounding reads well under this bar, and planted faults
# (a tensor scaled by each of PLANTED_SCALES; dk, dv missing half of each
# GQA group's q heads, one of two dk/dv splits left out) must read above
# it.  A 3 % scale is within the element-by-element bars wherever |w| < 1.
TRAIN_REL_TOL = 1e-2
PLANTED_SCALES = (0.9, 0.97)
# The f32-pipe kernels' times before the tensor-core route (PERF.md's
# kernel table, measured by this script on an H100 80GB HBM3 at 700 W),
# printed beside this run's.
EARLIER_MS = {
    "flash_attention yi-6b serve": "0.2934-0.3148",
    "flash_attention recurrentgemma-2b serve": "0.2421-0.2494",
    "flash_attention with LSE recurrentgemma-2b train": "3.556-3.658",
    "flash_attention_bwd recurrentgemma-2b train": "18.037-18.312",
    "flash_attention_bwd yi-6b train": "33.754-33.803",
}
TRAIN_LOSS_RTOL = 0.005
TRAIN_GRAD_TOL = 0.03

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
POLICIES = ("fifo", "tas", "prop", "libasl", "edf", "shfl", "dvfs_race")
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


# benchmarks/paper_figs.py's settings of the figures beyond fig1 (its
# FIG1_KW, FIG1_SLO, ENERGY_MIXES and the Bench-3 / Bench-5 axes), as the
# JAX package runs them.
FIG1_KW = {"tas": dict(w_big=0.15)}
FIG1_SLO = {"libasl": 1e9, "edf": 100.0}
ENERGY_MIXES = (8, 6, 4, 2, 0)
BENCH5_NC = (0.5, 1, 2, 4, 8, 16, 32, 64, 128)
BENCH3_PROBS = [1.0 - p / 100.0 for p in (0, 20, 40, 60, 80, 100)]


def fig_cfg(sl, policy, **kw):
    """``paper_figs._cfg(policy, 8, **kw)``: the fig1 calibration."""
    return sl.SimConfig(**{**FIG1, "policy": policy, "sim_time_us": MAIN_US,
                           **kw})


def bench1_cfg(sl, policy, **kw):
    """``paper_figs._bench1_cfg``: 4 critical sections over 2 locks."""
    return fig_cfg(sl, policy, **{**BENCH1, **kw})


def figure_grids(sl, energy) -> list:
    """The figure grids of phase 3b as (name, cfg, axes, slo_us, product),
    for either package's ``simlock`` and ``energy`` modules, in run order.
    Bench-1's second phase comes from :func:`bench1_phase2`."""
    b1 = bench1_cfg(sl, "fifo", policy_set=("fifo", "tas", "prop",
                                            "libasl"))
    w0 = b1.default_window_us
    grids = [("bench1 merged, phase 1", b1, {
        "policy": ["fifo", "tas", "prop", "fifo", "fifo", "fifo"],
        "w_big": [1.0, 8.0, 1.0, 1.0, 1.0, 1.0], "slo_us": [1e9] * 6,
        "window0_us": [w0] * 6}, 1e9, False)]
    long_kw = dict(long_epoch_prob=1.0, long_epoch_scale=100.0,
                   sim_time_us=120_000.0)
    grids += [
        ("bench3 libasl", bench1_cfg(sl, "libasl", **long_kw),
         {"long_epoch_prob": BENCH3_PROBS}, 400.0, True),
        ("bench3 fifo", bench1_cfg(sl, "fifo", **long_kw),
         {"long_epoch_prob": BENCH3_PROBS}, 1e9, True)]
    nc_ax = [(float(nc),) for nc in BENCH5_NC]
    b5 = dict(seg_cs_us=(2.0,), inter_epoch_us=0.5)
    grids += [
        ("bench5 fifo", fig_cfg(sl, "fifo", **b5),
         {"seg_noncrit_us": nc_ax, "n_cores": [8, 4]}, 1e9, True),
        ("bench5 tas", fig_cfg(sl, "tas", w_big=8.0, **b5),
         {"seg_noncrit_us": nc_ax}, 1e9, True),
        ("bench5 libasl", fig_cfg(sl, "libasl", default_window_us=1e5, **b5),
         {"seg_noncrit_us": nc_ax}, 1e9, True)]
    wk = {"wakeup_us": [0.0, 8.0, 20.0]}
    grids += [
        ("bench6 fifo", bench1_cfg(sl, "fifo", wakeup_us=20.0), wk, 1e9,
         True),
        ("bench6 libasl", bench1_cfg(sl, "libasl", wakeup_us=20.0), wk, 1e5,
         True)]
    grids += [(f"fig1 {p}", fig_cfg(sl, p, **FIG1_KW.get(p, {})),
               {"n_cores": list(range(1, 9))}, FIG1_SLO.get(p, 1e9), True)
              for p in ("edf", "shfl", "dvfs_race")]
    mixes = []
    for n_big in ENERGY_MIXES:
        big = (1,) * n_big + (0,) * (8 - n_big)
        mixes.append(dict(
            big=big, speed_cs=tuple(1.0 if b else CS_RATIO for b in big),
            speed_nc=tuple(1.0 if b else NC_RATIO for b in big),
            **energy.amp_power(big)))
    mix_axes = {k: [m[k] for m in mixes] for k in mixes[0]}
    grids += [(f"energy {p}", fig_cfg(sl, p, **FIG1_KW.get(p, {})), mix_axes,
               FIG1_SLO.get(p, 1e9), False) for p in POLICIES]
    return grids


def bench1_phase2(b1, fifo_p99: float) -> tuple:
    """Bench-1's libasl column (``paper_figs.bench1_contended``): SLOs
    from phase 1's fifo epoch P99, LibASL-MAX with the largest window."""
    w0 = b1.default_window_us
    slos = [0.0, fifo_p99, 1.5 * fifo_p99, 2.5 * fifo_p99, 5 * fifo_p99,
            1e5]
    return ("bench1 merged, phase 2", b1, {
        "policy": ["libasl"] * 6, "w_big": [1.0] * 6, "slo_us": slos,
        "window0_us": [w0] * 5 + [1e5]}, 1e9, False)


# benchmarks/paper_figs.py's load, excess-tail and chaos figures
# (loadlat_sweep, openloop_loadlat, excess_tail, chaos_collapse) and
# serving_bench.LOAD_FRACS, as the JAX package runs them.
LOAD_FRACS = (0.2, 0.4, 0.6, 0.8, 0.9)
LOADLAT_EV8MS = {
    ("fifo", 0.2): 606, ("fifo", 0.4): 1134, ("fifo", 0.6): 1612,
    ("fifo", 0.8): 1958, ("fifo", 0.9): 2094, ("fifo", 1.5): 2514,
    ("fifo", 3.0): 2427,
    ("tas", 0.2): 606, ("tas", 0.4): 1139, ("tas", 0.6): 1620,
    ("tas", 0.8): 1988, ("tas", 0.9): 2158, ("tas", 1.5): 2786,
    ("tas", 3.0): 3400,
    ("prop", 0.2): 606, ("prop", 0.4): 1150, ("prop", 0.6): 1620,
    ("prop", 0.8): 2013, ("prop", 0.9): 2200, ("prop", 1.5): 2938,
    ("prop", 3.0): 3822,
    ("libasl", 0.2): 615, ("libasl", 0.4): 1164, ("libasl", 0.6): 1677,
    ("libasl", 0.8): 2047, ("libasl", 0.9): 2254, ("libasl", 1.5): 2956,
    ("libasl", 3.0): 3257,
}
OPENLOOP_EV8MS = {
    ("fifo", 0.2): 906, ("fifo", 0.4): 1734, ("fifo", 0.6): 2562,
    ("fifo", 0.8): 3300, ("fifo", 0.9): 3690, ("fifo", 1.1): 3934,
    ("shfl", 0.2): 906, ("shfl", 0.4): 1734, ("shfl", 0.6): 2562,
    ("shfl", 0.8): 3300, ("shfl", 0.9): 3691, ("shfl", 1.1): 4288,
    ("libasl", 0.2): 910, ("libasl", 0.4): 1761, ("libasl", 0.6): 2644,
    ("libasl", 0.8): 3479, ("libasl", 0.9): 3991, ("libasl", 1.1): 4443,
}
LOAD_SEEDS = 6                    # LOADLAT_SEEDS and OPENLOOP_SEEDS
CHAOS_RATES = (0.0, 0.02, 0.05, 0.1, 0.2)
LOAD_SLO = {"loadlat": 200.0, "openloop": 300.0, "excess": 200.0,
            "chaos": 300.0}
CUT_US = 4000.0                   # the load grids' cut for kernel == plain
FEATURE_CUT_US = 1000.0           # the features cut's (7 merged policies)
DIURNAL_CUT_US = 2000.0           # the diurnal cut's


def loadlat_rate(frac: float) -> float:
    """``paper_figs._loadlat_rate``: the wl_rate that offers ``frac`` of
    the lock's capacity, by bisecting U(r) = sum_c cs_c / (cs_c +
    think_c / r) on the fig1 calibration."""
    cs = [3.0 * (1.0 if b else CS_RATIO) for b in BIG]
    think = [6.0 * (1.0 if b else NC_RATIO) for b in BIG]
    lo, hi = 1e-4, 1e4
    for _ in range(80):
        mid = (lo * hi) ** 0.5
        if sum(c / (c + th / mid) for c, th in zip(cs, think)) < frac:
            lo = mid
        else:
            hi = mid
    return float((lo * hi) ** 0.5)


def openloop_rate(frac: float) -> float:
    """``paper_figs._openloop_rate``: core c offers rate / base_c arrivals
    a microsecond (base = its closed-loop think budget), each holding the
    lock for its CS time."""
    cs = [3.0 * (1.0 if b else CS_RATIO) for b in BIG]
    base = [6.0 * (1.0 if b else NC_RATIO) for b in BIG]
    return frac / sum(c / b for c, b in zip(cs, base))


def load_grids(sl) -> list:
    """The load figures' grids as (name, cfg, axes, slo_us, product), for
    either package's ``simlock``, in run order: ``loadlat_sweep`` and
    ``openloop_loadlat`` (merged sets, 6 seed replicas a cell, horizons
    stretched by the event tables), ``excess_tail`` (histograms on) and
    ``chaos_collapse`` (one grid per policy, as the figure sweeps)."""
    wl = dict(wl=True, wl_process="poisson", wl_service="lognormal",
              wl_cv=1.0)
    grids = []
    fracs = LOAD_FRACS + (1.5, 3.0)
    cfg = fig_cfg(sl, "fifo", sim_time_us=80_000.0,
                  policy_set=("fifo", "tas", "prop", "libasl"), **wl)
    emax = max(LOADLAT_EV8MS.values())
    axes = {k: [] for k in ("policy", "arrival_rate", "w_big", "slo_us",
                            "seed", "sim_time_us")}
    for pol, w_big, slo in (("fifo", 1.0, 1e9), ("tas", 8.0, 1e9),
                            ("prop", 1.0, 1e9),
                            ("libasl", 1.0, LOAD_SLO["loadlat"])):
        for f in fracs:
            for seed in range(LOAD_SEEDS):
                for k, v in zip(axes, (pol, loadlat_rate(f), w_big, slo, seed,
                                       cfg.sim_time_us * emax
                                       / LOADLAT_EV8MS[pol, f])):
                    axes[k].append(v)
    grids.append(("loadlat_sweep", cfg, axes, 1e9, False))
    fracs = LOAD_FRACS + (1.1,)
    cfg = fig_cfg(sl, "fifo", sim_time_us=60_000.0, wl_open=True,
                  policy_set=("fifo", "shfl", "libasl"), **wl)
    emax = max(OPENLOOP_EV8MS.values())
    axes = {k: [] for k in ("policy", "arrival_rate", "slo_us", "seed",
                            "sim_time_us")}
    for pol, slo in (("fifo", 1e9), ("shfl", 1e9),
                     ("libasl", LOAD_SLO["openloop"])):
        for f in fracs:
            for seed in range(LOAD_SEEDS):
                for k, v in zip(axes, (pol, openloop_rate(f), slo, seed,
                                       cfg.sim_time_us * emax
                                       / OPENLOOP_EV8MS[pol, f])):
                    axes[k].append(v)
    grids.append(("openloop_loadlat", cfg, axes, 1e9, False))
    cfg = fig_cfg(sl, "fifo", sim_time_us=40_000.0, hist=True,
                  policy_set=("fifo", "tas", "libasl"), **wl)
    axes = {k: [] for k in ("policy", "arrival_rate", "w_big", "slo_us")}
    for pol, w_big, slo in (("fifo", 1.0, 1e9), ("tas", 8.0, 1e9),
                            ("libasl", 1.0, LOAD_SLO["excess"])):
        for f in LOAD_FRACS + (1.5,):
            for k, v in zip(axes, (pol, loadlat_rate(f), w_big, slo)):
                axes[k].append(v)
    grids.append(("excess_tail", cfg, axes, 1e9, False))
    for pol in POLICIES:
        cfg = fig_cfg(sl, pol, sim_time_us=60_000.0, preempt_scale_us=50.0,
                      fault_mask=tuple(0.0 if b else 1.0 for b in BIG),
                      **FIG1_KW.get(pol, {}))
        grids.append((f"chaos {pol}", cfg,
                      {"preempt_rate": list(CHAOS_RATES)},
                      LOAD_SLO["chaos"], True))
    return grids


def load_cuts(sl, grids) -> list:
    """The cuts phase 3c holds the kernel to the plain step on: each load
    figure's (chaos_collapse's on fifo and libasl) and the features'."""
    return [cut_grid(g) for g in grids if not g[0].startswith("chaos")
            or g[0] in ("chaos fifo", "chaos libasl")] + [feature_cut(sl)]


def cut_grid(grid: tuple) -> tuple:
    """A load grid cut for the kernel against the plain step: a few of
    its cells (each policy at a light and at its heaviest load, or a
    chaos grid's lightest and heaviest preemption), 4,000 us each."""
    name, cfg, axes, slo, product = grid
    import dataclasses
    cfg = dataclasses.replace(cfg, sim_time_us=CUT_US)
    if name.startswith("chaos"):
        return (f"{name} cut", cfg, {"preempt_rate": [0.0, 0.2]}, slo, True)
    n = len(axes["policy"])
    per = n // len(cfg.policy_set)
    step = LOAD_SEEDS if "seed" in axes else 1
    keep = [p * per + i for p in range(len(cfg.policy_set))
            for i in (step, per - 1)]
    cut = {k: [v[i] for i in keep] for k, v in axes.items()
           if k != "sim_time_us"}
    return (f"{name} cut", cfg, cut, slo, False)


def feature_cut(sl) -> tuple:
    """The stochastic features the load figures leave out, as one cut
    grid (1,000 us: the plain step runs all seven policies' hooks a
    step): the seven policies merged, MMPP arrivals, the four service
    distributions side by side (the per-core column), churn, straggling
    and preemption on the little cores, and the histograms."""
    cfg = fig_cfg(sl, "fifo", sim_time_us=FEATURE_CUT_US, wl=True,
                  wl_process="mmpp", wl_burst=4.0, wl_burst_len=4.0,
                  wl_service_per_core=("det", "exp", "lognormal",
                                       "bimodal") * 2,
                  wl_mix=0.2, wl_mix_scale=8.0, hist=True, hist_warmup=8,
                  churn_rate=0.1, churn_period_us=200.0, straggle_rate=0.05,
                  preempt_rate=0.05,
                  fault_mask=tuple(0.0 if b else 1.0 for b in BIG))
    axes = {"policy": list(POLICIES),
            "arrival_rate": [loadlat_rate(f) for f in (
                0.2, 0.6, 0.9, 1.5, 3.0, 0.4, 0.8)],
            "seed": list(range(7))}
    return ("features cut", cfg, axes, LOAD_SLO["loadlat"], False)


def diurnal_cut(sl) -> tuple:
    """The diurnal arrival ramp, closed loop, as one cut grid (2,000 us):
    fifo and libasl merged, amplitude 0.8 over a 1,000 us period,
    lognormal service, each policy at loads 1.5 and 3.0, with
    long epochs and the wakeup on (the think draw times the long-epoch
    draw, which no other cut reaches).  Its sine is at parity level 3
    against the JAX package (libm's ``sinf`` there), so no JAX digest
    holds it: the card holds the kernel to the plain step, and the CPU
    tests hold the plain step to JAX at summary level."""
    cfg = fig_cfg(sl, "fifo", sim_time_us=DIURNAL_CUT_US, wl=True,
                  wl_process="diurnal", wl_amp=0.8, wl_period_us=1000.0,
                  wl_service="lognormal", wl_cv=1.0, long_epoch_prob=0.3,
                  long_epoch_scale=10.0, wakeup_us=2.0,
                  policy_set=("fifo", "libasl"))
    axes = {"policy": ["fifo", "fifo", "libasl", "libasl"],
            "arrival_rate": [loadlat_rate(f) for f in (1.5, 3.0) * 2],
            "slo_us": [1e9, 1e9, LOAD_SLO["loadlat"], LOAD_SLO["loadlat"]],
            "seed": [0, 1, 2, 3]}
    return ("diurnal cut", cfg, axes, LOAD_SLO["loadlat"], False)


# benchmarks/paper_figs.py's keyshard figure: four zipped 9-cell sweeps
# (a theta column at 16 locks and a lock-count column at theta 0.99) over
# 4,096 keys, one per dispatch policy; plain fifo under keys is the CRCW
# baseline.
KEYSHARD_THETAS = (0.0, 0.5, 0.9, 0.99, 1.2)
KEYSHARD_LOCKS = (1, 2, 4, 8)
KEYSHARD_POLICIES = (("fifo", "crcw"), ("ks_erew", "erew"),
                     ("ks_crew", "crew"), ("ks_jbsq", "jbsq"))
KEYSHARD_KEYS, KEYSHARD_NLOCKS = 4096, 16
# The horizons of phase 3d's kernel-against-plain cuts: the plain step
# costs 10-30 ms a step on the card with the key draws, so they are cut
# to keep the phase near a minute.
KEY_CUT_US = 1500.0               # the merged keyed cut's
KEY_OPEN_CUT_US = 500.0           # the open-loop keyed cut's
KEYS_OFF_US = 1000.0              # the ks_* policies' runs with keys off


def keyshard_axes() -> dict:
    """``paper_figs.keyshard``'s zipped theta / lock-count columns."""
    return {"zipf_theta": list(KEYSHARD_THETAS)
            + [0.99] * len(KEYSHARD_LOCKS),
            "n_locks": [KEYSHARD_NLOCKS] * len(KEYSHARD_THETAS)
            + list(KEYSHARD_LOCKS)}


def keyshard_grids(sl) -> list:
    """The keyshard figure's grids as (name, cfg, axes, slo_us, product),
    for either package's ``simlock``: one per policy, full length."""
    return [(f"keyshard {label}",
             fig_cfg(sl, pol, n_locks=KEYSHARD_NLOCKS, n_keys=KEYSHARD_KEYS),
             keyshard_axes(), 1e9, False)
            for pol, label in KEYSHARD_POLICIES]


def keyshard_cuts(sl) -> list:
    """The keyed cuts phase 3d holds the kernel to the plain step on: the
    figure's 36 cells as one merged set (1,500 us), and an open loop
    (``wl_open``, Poisson arrivals, exponential service) of fifo and
    ks_crew merged at two loads (500 us)."""
    pols = tuple(p for p, _ in KEYSHARD_POLICIES)
    ax = keyshard_axes()
    cfg = fig_cfg(sl, "fifo", sim_time_us=KEY_CUT_US,
                  n_locks=KEYSHARD_NLOCKS, n_keys=KEYSHARD_KEYS,
                  policy_set=pols)
    merged = {"policy": [p for p in pols for _ in ax["n_locks"]],
              **{k: v * len(pols) for k, v in ax.items()}}
    open_cfg = fig_cfg(sl, "fifo", sim_time_us=KEY_OPEN_CUT_US,
                       n_locks=KEYSHARD_NLOCKS, n_keys=KEYSHARD_KEYS,
                       wl_open=True, wl=True, wl_process="poisson",
                       wl_service="exp", policy_set=("fifo", "ks_crew"))
    open_axes = {"policy": ["fifo", "fifo", "ks_crew", "ks_crew"],
                 "arrival_rate": [openloop_rate(f) for f in (0.6, 1.1) * 2],
                 "seed": [0, 1, 2, 3]}
    return [("keyshard merged cut", cfg, merged, 1e9, False),
            ("keyshard open cut", open_cfg, open_axes, 1e9, False)]


# benchmarks/paper_figs.py's closed-loop figures that phase 3e holds at
# full length: fig1_collapse for the registered policies phase 3b does not
# run (grids "collapse <policy>"; 3b's are "fig1 <policy>"),
# fig4_big_affinity, fig5_proportional, bench1_slo_sweep and
# bench4_scalability (its libasl grid from the tas rows, as Bench-1's
# phase 2 comes from phase 1: bench4_phase2), then bench2_variable's four
# runs with the windows carried (bench2_phases).
FIG1_MORE = ("fifo", "tas", "prop", "libasl", "ks_erew", "ks_crew",
             "ks_jbsq")
BENCH4 = dict(seg_cs_us=(6.0,), seg_noncrit_us=(0.5,), inter_epoch_us=2.0)
BENCH2_US, BENCH2_SLO = 40_000.0, 150.0
BENCH2_PHASES = (("base", {}), ("x8", dict(seg_noncrit_us=(8.0, 4.0, 4.0,
                                                          4.0))),
                 ("back", {}), ("x256", dict(seg_noncrit_us=(
                     256.0, 128.0, 128.0, 128.0))))
# examples/lock_microbench.py's Figure 8b: sweep_slo on the default config.
FIG8B_SLOS = (20.0, 40.0, 60.0, 80.0, 100.0, 150.0, 200.0)
FIG8B_US = 50_000.0
# Phase 3f's resumable sweeps' slices, and its split counts.
RESUME_CHUNKS = (7, 64)
SPLITS = (2, 3, 4)


def closed_grids(sl) -> list:
    """Phase 3e's grids as (name, cfg, axes, slo_us, product), for either
    package's ``simlock``, in run order (Bench-4's libasl grid from
    :func:`bench4_phase2`, Bench-2 from :func:`bench2_phases`)."""
    ns = {"n_cores": list(range(1, 9))}
    grids = [(f"collapse {p}", fig_cfg(sl, p, **FIG1_KW.get(p, {})), ns,
              FIG1_SLO.get(p, 1e9), True) for p in FIG1_MORE]
    grids += [(f"fig4 {p}", fig_cfg(sl, p, seg_cs_us=(6.0,), **kw), ns,
               1e9, True) for p, kw in (("fifo", {}),
                                        ("tas", dict(w_big=8.0)))]
    grids.append(("fig5 prop", fig_cfg(sl, "prop"),
                  {"prop_n": [1, 2, 5, 10, 20, 50]}, 1e9, True))
    import numpy as np
    # numpy floats, as paper_figs passes them (an SLO's ticks are rounded
    # by its type: the reference's _cell_params).
    grids.append(("fig8b bench1_slo_sweep", bench1_cfg(sl, "libasl"),
                  {"slo_us": list(np.linspace(20.0, 400.0, 14))}, 1e9,
                  True))
    grids += [(f"bench4 {p}", fig_cfg(sl, p, **kw, **BENCH4), ns, 1e9, True)
              for p, kw in (("fifo", {}), ("tas", dict(w_big=8.0)))]
    return grids


def bench4_phase2(sl, tas_p99) -> tuple:
    """Bench-4's zipped 24-cell libasl grid: at each n, SLO 0, the tas
    row's epoch P99 and LibASL-MAX (SLO and window 1e5)."""
    cfg = fig_cfg(sl, "libasl", **BENCH4)
    w = cfg.default_window_us
    axes = {"n_cores": [], "slo_us": [], "window0_us": []}
    for n, p99 in zip(range(1, 9), tas_p99):
        for slo, w0 in ((0.0, w), (p99, w), (1e5, 1e5)):
            for k, v in zip(axes, (n, slo, w0)):
                axes[k].append(v)
    return ("bench4 libasl", cfg, axes, 1e9, False)


def bench2_phases(sl) -> list:
    """Bench-2's four runs as (name, cfg): libasl on the Bench-1 program,
    40,000 us each, the noncritical sections x8, back, x256; each
    ``run(cfg, BENCH2_SLO, 0, windows)`` carries the previous window."""
    return [(f"bench2 {tag}", bench1_cfg(sl, "libasl", sim_time_us=BENCH2_US,
                                         **kw)) for tag, kw in BENCH2_PHASES]


def amp_grid(sl, clients, generators) -> tuple:
    """The multi-tenant grid of phase 3f: ``amp_config`` with a big-affine
    class at SLO 50 and a little-affine bimodal class at SLO 500, libasl
    with ``wl`` on at fig1's 60,000 us, seeds 0-3, run at the base SLO."""
    mix = clients.WorkloadMix((
        clients.ClientClass("lc", weight=1.0, slo=50.0, affinity="big"),
        clients.ClientClass("be", weight=1.0, slo=500.0, affinity="little",
                            service=generators.ServiceSpec("bimodal",
                                                           mix=0.3))))
    cfg, _ = clients.amp_config(fig_cfg(sl, "libasl", wl=True), mix,
                                base_slo=50.0)
    return ("amp_config libasl", cfg, {"seed": [0, 1, 2, 3]}, 50.0, True)


def fig8b_cfg(sl):
    """examples/lock_microbench.py's Figure 8b config."""
    return sl.SimConfig(policy="libasl", sim_time_us=FIG8B_US)


def full_digest(st) -> str:
    """sha256 over every leaf of a numpy state (reference dtypes), the
    pol slots included, in field order."""
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for k in st._fields:
        v = getattr(st, k)
        for x in ([v[n] for n in sorted(v)] if k == "pol" else [v]):
            h.update(np.ascontiguousarray(np.asarray(x)).tobytes())
    return h.hexdigest()


# full_digest of the JAX package's final state of each figure grid.
# tests/test_torch_simstep_figs.py recomputes them with JAX (the keyshard
# grids: tests/test_torch_figure_digests_keys.py; phase 3e's and 3f's:
# tests/test_torch_figure_digests_closed*.py), but for the load grids
# (loadlat_sweep ... chaos dvfs_race), recorded once from the JAX package:
# 10 grids, 10.4M events, about 80 s on a CPU.  Bench-2's entries are each
# carried run's final state, without the cell axis.
FIGURE_DIGESTS = {
    "bench1 merged, phase 1":
        "51eea560a1233c20002c568c3322769f1cdb5a8a1a2307de9959c46006126bd7",
    "bench1 merged, phase 2":
        "0601afce23b8bd16caa99af8339314a8bf4d99f312d59d6bbcf06c211949c1a0",
    "bench3 libasl":
        "fee4aca41a2dd98c1f45758758049a81b38a725c485b8c4337a4012cef6cd3e7",
    "bench3 fifo":
        "f6f17673bfa9b334a58ffce7ecd15b39311f75f15789f30be529750e9074f6fd",
    "bench5 fifo":
        "88fbf0795262e2d0afd3a02fee2cb9bbbd43bfe05b98d2ee1f69d7f3a48a9390",
    "bench5 tas":
        "1549155fad5a20e7d9b028e7011685c0d700140c9022b241264f0a4152a4c2fd",
    "bench5 libasl":
        "88c1fd3c30d67a55000795d560b751075c7b913de26884dd25bbd3ab9037564c",
    "bench6 fifo":
        "93d2760e1a9bfb4e6c87cf30019034b6630c039188f5b88b900dfc5f4700d3b1",
    "bench6 libasl":
        "e08664f98a2ab205346f89de5eab1fa9ce07705f291c94e3ee6af1951ad3bbeb",
    "fig1 edf":
        "e664dc408eb59e0bc3d2817937fdbbc205fa2904563ce193be786b098878c659",
    "fig1 shfl":
        "918d81e921cdb2cd8f85c2991122490b01ef785ab85c2a2ad11792e57f15fe49",
    "fig1 dvfs_race":
        "d7ed105d77699bb2142fc7634ea7c94feff4a8e322c1edc7002766954c702f9b",
    "energy fifo":
        "7fd77b896c3d6e294acac9497ea56ce16e99ee55c4e90c222c459251d2113bdb",
    "energy tas":
        "be5aec17f866922bcaf54d30954df10994f78656ac1dac041ab52050a3da808e",
    "energy prop":
        "650ce8517e19b516c638e93282c50e32bd798075eaab450bd89d1bcdca974969",
    "energy libasl":
        "f3301c5b1ce3abfaad9f84e44d94540f943cc6afae238c5161a248bd8999432b",
    "energy edf":
        "6c1f705cc1b3a603950d19b793eaa8c594da3ba7e48c756038a6083f876603c3",
    "energy shfl":
        "f5e94de6c0c368f443a55254639570b20ce1a5160bcd30255f1242fd0739757e",
    "energy dvfs_race":
        "983846f798c5ff9b931887dadafb55603d1ba1b56358dda886fa01d33877ff2b",
    "loadlat_sweep":
        "5e61b5fc7073c44bc4ea46564cd6d9f70121b18768e26c15f74d0142735412b2",
    "openloop_loadlat":
        "c3c729423be0ec4583189e500dd9fd824a96b97b67b9f14ffa36b10be6a480cd",
    "excess_tail":
        "ce1e69012d2c4def4aee750d8c79c18d16b1c0d4d6809c76f0565e7af5df53e9",
    "chaos fifo":
        "0595bfc603163adb47ba0187a4c77ec4775168adc80b3a921e6630c3298665cc",
    "chaos tas":
        "fc2f35ab99d34aeae6ea80e9b18ec968a2f5db03393ada4756f35cba4171f85a",
    "chaos prop":
        "b2751b12cd4c418dd94ce25c5bec2259b624750eacf185f0dfc07de6c7d55250",
    "chaos libasl":
        "60ba773e3a3158dd87b9415018afece0bf999c52641d72b7530cfac230740c8a",
    "chaos edf":
        "f1d2345952bd7c29daacdbc81b7fef6b8bfaaddb96636e864eecafc847287bd2",
    "chaos shfl":
        "6d58c6b11c680199988565c5e86b6e700633562b55c961a905ea77c1ab9114b5",
    "chaos dvfs_race":
        "69e689ba0c135a89592f3240e9fd65988064b1809b5cca5c417e852efbfaf32d",
    "keyshard crcw":
        "935761fa6fab1a1da9e16273e0cc87c2cbaf4396aaba49c2cd60cb222bff114e",
    "keyshard erew":
        "393d38dd6f0b4ad419722434457a2af20884cfbb4ae8a756c33b5808eda18573",
    "keyshard crew":
        "d3da3453b6562379cabf5a4b18e29d125b3d007cb0848e8d816f888d24d5710d",
    "keyshard jbsq":
        "341c61b142b4c8b76f76ab8a536745a57f4aa9271a341c2df757d9d44069f639",
    "collapse fifo":
        "0786bd3c028e0a1ec0168fec376b92943e703d051bbe6d1855f897fcdda64c52",
    "collapse tas":
        "fe8491c38bf58b7cc9f088d8cab974443e1abe5b3d4d934ebd199306f78e6cdd",
    "collapse prop":
        "2fa24049a0e0d88950e6fc803bc01fc4a7b48282a01bee4121b5606482fc117e",
    "collapse libasl":
        "ec262a5470ea43ec0984045b9a496ce66a87a32612141a2435bd77403cccf34e",
    "collapse ks_erew":
        "a0bd5c24f6746204eca59026f8c128ca7df223452e7397eaba07ce3f9ed7fa28",
    "collapse ks_crew":
        "502ea73695a362ca03706d3d4b32611839b6620c72c1316fef7f24773b6834f0",
    "collapse ks_jbsq":
        "7f398482255b483cd0c5adae969d45a9144621dbc9549defe96ddc688af3d2f5",
    "fig4 fifo":
        "ee5e5564d80911b7c17c69e06944563ed3221ade5431b20f8ef0c2d55894eb08",
    "fig4 tas":
        "44d2252b52a09f553abf49002f7332988c5591fdbe220a5642f8ca3bac52e471",
    "fig5 prop":
        "f8cc57eb43a100e10aff8156148a66996d3e06b2db481856c53c1ffe462a9672",
    "fig8b bench1_slo_sweep":
        "33b8d1bec7ee6d113c387573289f50d30bae44f7f27c10555f19faa9801a02c1",
    "bench4 fifo":
        "75f9de34cc28ec4fb47c0e2d860cf4993ba28cc2e0236738b4fc997de4b05342",
    "bench4 tas":
        "e2c049636d0dfa7130432dafd334abd3517ce7d4bd2d815f78e6c21d6b552728",
    "bench4 libasl":
        "b201484d09f41124aed9a0ba5aa9313f0e37fa3de8baf7e3517f48694ac00249",
    "bench2 base":
        "762796e66c5f58e0b3f127bbc3ca32336dd1e6fb91c91a753a0866a1ad60b4d7",
    "bench2 x8":
        "75b7a7b0b399bb896cdce6d0c7738b1e5c2726578e3ca31da3112a16b31d8b66",
    "bench2 back":
        "3f36d95ee05c2df3ad720e820ee3b848b60836911e16d0faa98c778fe84a13ff",
    "bench2 x256":
        "cb57db7903b76a0321d2d135ccce21a67037a4e8bd507a77bffc387ad36b366f",
    "amp_config libasl":
        "5cdf606db6103e1b7138675a70fa72a34ecbd2dbed295466de88013037cc1055",
    "figure8b sweep_slo":
        "d014a55300bf04f9cfc5108d2f1271ef0023fa8e97d57d97c82df43716c17eac",
}
# full_digest of the JAX package's final state of each load grid's cut
# (cut_grid) and of FEATURE_CUT.  tests/test_torch_figure_digests_load.py
# recomputes them with JAX.
CUT_DIGESTS = {
    "loadlat_sweep cut":
        "5cb019040e659dd31b73f09f48eef5eb0867b946073d6d3af85b3f20610c6563",
    "openloop_loadlat cut":
        "959c20c232ab3057daeee28af7ccaeb00469e2fa830f3435f46a8563d59afcce",
    "excess_tail cut":
        "234baa68bbc2c0a2798a2b61f8dea1276ec768e4e43df19c477e4b6c437d2bc0",
    "chaos fifo cut":
        "bc92a299cc5a9aeff00c785072373566e0013a17869fc998cc26016047ee34a1",
    "chaos libasl cut":
        "278ae00bc5b90087f3cf49f0944178504c0427bc53765192dc167af65199ff4d",
    "features cut":
        "ad8fc2d9ee4120d6a99a5ebad69476f050ca2a6125e9222f04bdfee44bf90598",
}
# full_digest of the JAX package's final state of each keyed cut
# (keyshard_cuts).  tests/test_torch_figure_digests_keys.py recomputes
# them with JAX.
KEYSHARD_CUT_DIGESTS = {
    "keyshard merged cut":
        "e3ec0223138db618ae2161bb7673d8cf3c151f64482adee8a4e6f8d75bc5241b",
    "keyshard open cut":
        "ea6005fabaa410bbde6e8b9a7ce135a5697426d847fcf018391c31b5a210e716",
}


# examples/serving_bench_torch.py's rows_digest of each section of the
# JAX package's benchmarks/serving_bench.py at SCALE 1.0 (the fleet
# dispatcher, the serving engine and the staleness simulation, all
# host-side).
# tests/test_torch_serving_bench.py recomputes them with the JAX package.
FLEET_DIGESTS = {
    "db_serving":
        "17065665f02d43ede40f6644ed9adbc95bcf2ed87b96779cf4c7ebff79d41b52",
    "db_multiclass":
        "4dfea0f559efd8d61c8069087a614067eee7044e1ccf7ee0af2ae0f711c52bb6",
    "dispatch_fleet":
        "abecf5e719dad5ea8b39a1bc742d8296fa6c17408008595857352d05af1e90f1",
    "straggler_training":
        "ea2cc7567932e17bc0f424750c8736ca6399ef97d1f55675a602caad35897ace",
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
    """The kernel and template arguments that ptxas's "Compiling entry
    function" line names, readable: ``dq(f32, 256, 64, 32)`` for
    ``...9dq_kernelIfLi256ELi64ELi32EE...``, ``dkv_reduce()`` for a
    kernel that is no template; ``keyed`` marks ``fused_chunk``'s
    overload that takes ``ArgsK``."""
    import re
    m = re.search(r"(?<=[0-9])([a-z_]+)_kernel(?:I(.*?)EEv)?", line)
    if not m:
        return ""
    args = (m.group(2) or "").replace("13__nv_bfloat16", "bf16,").replace(
        "Lb1", "stochastic").replace("Lb0", "det").replace(
        "Li", "").replace("E", ",")
    args = re.sub(r"^f", "f32,", args)
    if "5ArgsK" in line:
        args += ",keyed"
    return m.group(1) + "(" + ", ".join(a for a in args.split(",") if a) \
        + ")"


def ptxas_bytes(build, name, pattern) -> dict:
    """Each kernel instantiation's bytes that ``pattern``'s groups count
    (summed), from ptxas's report in the build logs of ``csrc/<name>.cu``
    (each of its libraries')."""
    import re
    out, entry = {}, ""
    for part in range(build.parts(name)):
        for line in build.lib_path(name, part).with_suffix(".log") \
                .read_text().splitlines():
            if "Compiling entry" in line:
                entry = instantiation(line)
            m = re.search(pattern, line)
            if m:
                out[entry] = sum(int(g) for g in m.groups())
    return out


def stack_frames(build, name) -> dict:
    """Each kernel instantiation's stack frame in bytes (ptxas)."""
    return ptxas_bytes(build, name, r"(\d+) bytes stack frame")


def spills(build, name) -> dict:
    """Each kernel instantiation's spill bytes, stores and loads (ptxas)."""
    return ptxas_bytes(build, name,
                       r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def clone(st):
    return type(st)(**{k: {n: x.clone() for n, x in v.items()} if k == "pol"
                       else v.clone() for k, v in st._asdict().items()})


def leaves(st) -> dict:
    """name -> tensor, the pol slots as ``pol.<name>``."""
    out = {}
    for k, v in st._asdict().items():
        if k == "pol":
            out.update({f"pol.{n}": x for n, x in sorted(v.items())})
        else:
            out[k] = v
    return out


def leaf_diff(a, b) -> tuple:
    """(names of leaves that differ, max abs difference over all leaves)."""
    import torch
    bad, err = [], 0.0
    lb = leaves(b)
    for k, x in leaves(a).items():
        y = lb[k]
        if not torch.equal(x, y):
            bad.append(k)
        d = (x.double() - y.double()).abs().max().item() if x.numel() else 0
        err = max(err, float(d))
    return bad, err


def parity_case(sl, simstep, name, cfg, axes, product=True) -> None:
    """One small grid through the kernel and the plain version."""
    cfg = sl.sweep_config(cfg, axes)
    tb, pm, st, _ = sl.init_sweep(cfg, axes, slo_us=80.0, product=product,
                                  device="cuda")
    ref = clone(st)
    n0 = simstep.fused_chunk.launches
    kernel_ms = cuda_ms(lambda: sl.simulate(cfg, tb, pm, st))
    plain_ms = cuda_ms(lambda: sl.simulate(
        cfg, tb, pm, ref, chunk_fn=simstep.fused_chunk_ref))
    bad, _ = leaf_diff(st, ref)
    n = simstep.fused_chunk.launches - n0
    print(f"parity {name}: {st.events.numel()} cells, "
          f"{int(st.events.sum())} events, {n} launches, kernel "
          f"{kernel_ms / 1e3:.3f} s, plain {plain_ms / 1e3:.1f} s, "
          f"differing leaves: {bad or 'none'}", flush=True)
    if bad or n <= 0:
        raise AssertionError(f"kernel != plain for {name}")


def parity_jobs(sl, simstep) -> list:
    """Phase 2's comparisons, kernel == plain version on the card, every
    leaf, small grids: each policy, each with the gated features on, the
    merged set, and chunk 1 against chunk 128; -> [(name, thunk)]."""
    from functools import partial
    from repro_torch.core import energy
    axes = {"n_cores": [4, 8], "slo_us": [40.0, 90.0], "seed": [0, 1, 2, 3]}
    jobs = []
    for pol in POLICIES:
        for prog, kw in (("fig1", FIG1), ("bench1", BENCH1)):
            jobs.append(partial(parity_case, sl, simstep, f"{pol}/{prog}",
                                sl.SimConfig(policy=pol, sim_time_us=4000.0,
                                             **kw), axes))
    # Long epochs, the wakeup cost and the energy model, all on.
    feats = dict(BENCH1, long_epoch_prob=0.3, long_epoch_scale=10.0,
                 wakeup_us=2.0, **energy.amp_power(BIG))
    for pol in POLICIES:
        jobs.append(partial(parity_case, sl, simstep,
                            f"{pol}/bench1+features", sl.SimConfig(
                                policy=pol, sim_time_us=2000.0, **feats),
                            axes))
    merged = {"policy": list(POLICIES) * 2,
              "slo_us": [40.0] * 7 + [90.0] * 7,
              "w_big": [1.0, 8.0, 1.0, 1.0, 1.0, 1.0, 1.0] * 2,
              "shfl_bound": [4] * 7 + [1] * 7,
              "race_bound": [8] * 7 + [2] * 7}
    jobs.append(partial(parity_case, sl, simstep, "merged 7/bench1+features",
                        sl.SimConfig(sim_time_us=2000.0, **feats), merged,
                        product=False))
    jobs.append(partial(chunk_parity, sl, axes))
    return [(f"2 {j.args[2]}" if j.func is parity_case else "2 chunk", j)
            for j in jobs]


def chunk_parity(sl, axes) -> None:
    """libasl through the kernel at chunk 1 and at chunk 128: every leaf
    equal."""
    import dataclasses
    import torch
    cfg = sl.SimConfig(policy="libasl", sim_time_us=4000.0, **FIG1)
    tb, pm, st, _ = sl.init_sweep(cfg, axes, device="cuda")
    one = clone(st)
    sl.simulate(cfg, tb, pm, st)
    sl.simulate(dataclasses.replace(cfg, chunk=1), tb, pm, one)
    torch.cuda.synchronize()
    bad, _ = leaf_diff(st, one)
    print(f"parity libasl chunk=1 vs chunk=128: differing leaves: "
          f"{bad or 'none'}", flush=True)
    if bad:
        raise AssertionError("chunk=1 != chunk=128")


def plain_jobs(sl, simstep) -> list:
    """Every kernel-against-plain-step comparison on the card, as [(name,
    thunk)], the longest first: phase 3c's cuts (each load figure's, the
    features' and the diurnal one), phase 3d's (the keyed cuts, each
    ``ks_*`` policy with keys off), then phase 2's.  The plain step is
    thousands of small launches a step, bound by the host, so
    :func:`run_plain_jobs` runs these in several processes."""
    from functools import partial
    jobs = [(f"3c {c[0]}", partial(cut_run, sl, simstep, c))
            for c in load_cuts(sl, load_grids(sl))]
    jobs.append(("3c diurnal cut", partial(cut_run, sl, simstep,
                                           diurnal_cut(sl), level3=True)))
    jobs += [(f"3d {c[0]}", partial(cut_run, sl, simstep, c))
             for c in keyshard_cuts(sl)]
    axes = {"n_cores": [4, 6, 8]}
    for pol, knob in (("ks_erew", "erew_bound"), ("ks_crew", "crew_bound"),
                      ("ks_jbsq", "jbsq_k")):
        for prog, kw in (("fig1", FIG1), ("bench1", BENCH1)):
            jobs.append((f"3d {pol}/{prog} keys off", partial(
                parity_case, sl, simstep, f"{pol}/{prog} keys off",
                sl.SimConfig(policy=pol, sim_time_us=KEYS_OFF_US, **kw),
                {**axes, knob: [1, 4]})))
    return jobs + parity_jobs(sl, simstep)


# The processes run_plain_jobs spreads the comparisons over (each drives
# its own launches on the one card, and takes a host core or so; the run
# prints the cores it was given).
PLAIN_WORKERS = 4
_JOBS = []


def _plain_job(i: int) -> tuple:
    """Run plain job ``i`` in a worker process, its printed lines
    captured; -> (i, ok, the lines, seconds)."""
    import contextlib
    import io
    if not _JOBS:
        import torch
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.core import simlock as sl
        from repro_torch.kernels import simstep
        _JOBS.extend(plain_jobs(sl, simstep))
    out = io.StringIO()
    t0 = time.time()
    ok = True
    with contextlib.redirect_stdout(out):
        try:
            _JOBS[i][1]()
        except Exception:
            traceback.print_exc(file=out)
            ok = False
    return i, ok, out.getvalue(), time.time() - t0


def run_plain_jobs(sl, simstep) -> None:
    """:func:`plain_jobs` in ``PLAIN_WORKERS`` spawned processes, each job
    in the next free one, the longest first; each job's lines printed as
    it finishes.  Fails if any job fails, and at once if a worker process
    dies (a fault in a kernel, say) instead of waiting on it."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor, as_completed
    names = [n for n, _ in plain_jobs(sl, simstep)]
    t0 = time.time()
    bad = []
    with ProcessPoolExecutor(PLAIN_WORKERS,
                             mp_context=mp.get_context("spawn")) as pool:
        for done in as_completed([pool.submit(_plain_job, i)
                                  for i in range(len(names))]):
            i, ok, text, secs = done.result()
            print(text, end="")
            print(f"  [{names[i]}: {secs:.1f} s in its process]", flush=True)
            bad += [] if ok else [names[i]]
    print(f"kernel against plain step (phases 2, 3c, 3d): {len(names)} "
          f"comparisons in {PLAIN_WORKERS} processes on "
          f"{len(os.sched_getaffinity(0))} host cores, "
          f"{time.time() - t0:.1f} s", flush=True)
    if bad:
        raise AssertionError(f"kernel != plain step: {bad}")


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
    took ``before`` to ``after``): the bytes ``simstep.launch_bytes``
    counts (in each launch every cell that retires an event reads the
    kernel's tables, params and state, rings and histograms excepted, once
    and writes its state once; each recorded latency writes one 4-byte
    ring sample and each histogram sample reads and writes one 4-byte
    count), the count the sweep records use.  The operations (argmin
    compares and handler steps per event) take far less time than the
    bytes."""
    n_bytes = simstep.launch_bytes(tb, pm, before, after, cfg, launches)
    ev = after.events - before.events
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
    """The main path: four full-size sweeps through the kernel, each as
    ``sweep`` runs it, ``init_sweep`` then ``simulate``, with the host's
    clock read around each part after a synchronisation, so the parts sum
    to the sweep's wall time.  Beside each sweep's wall time and events/s:
    the launches past the last live chunk (``simulate`` checks for live
    cells once per ``LIVENESS_GROUP`` launches; checking after every
    launch would stop at the most chunks any cell needs), and, from the
    same sweep run again under ``torch.profiler`` (not counted), the card
    time of its ``fused_chunk`` launches and the time ``simulate`` spends
    outside them."""
    import numpy as np
    import torch
    torch.cuda.reset_peak_memory_stats()
    simstep.fused_chunk.launches = 0
    runs = {}
    for pol in ("libasl", "tas", "prop", "fifo"):
        cfg = sl.SimConfig(policy=pol, sim_time_us=MAIN_US, epcap=8192,
                           **FIG1)
        n0 = simstep.fused_chunk.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tb, pm, st, grid = sl.init_sweep(cfg, MAIN_GRID[pol], device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sl.simulate(cfg, tb, pm, st)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        runs[pol] = (cfg, st, grid, (t2 - t0) * 1e3, (t1 - t0) * 1e3,
                     (t2 - t1) * 1e3, simstep.fused_chunk.launches - n0)
    launches = simstep.fused_chunk.launches
    peak = torch.cuda.max_memory_allocated()
    total_ev, total_ms, total_over = 0, 0.0, 0
    for pol, (cfg, st, grid, ms, init, sim, n) in runs.items():
        ev = st.events.cpu().numpy()
        total_ev += int(ev.sum())
        total_ms += ms
        over = n - int(-(-ev.max() // cfg.chunk))
        total_over += over
        print(f"main {pol}: {ev.size} cells, {int(ev.sum())} events, "
              f"{ms / 1e3:.3f} s ({init:.1f} ms init_sweep, {sim:.1f} ms "
              f"simulate), {ev.sum() / (ms / 1e3):.0f} events/s, {n} "
              f"launches ({over} past the last live chunk)", flush=True)
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
    # Each sweep again under the profiler, not counted: the card time of
    # its fused_chunk launches, and simulate's time outside them.
    init_ms = sim_ms = card_ms = 0.0
    for pol, (cfg, *_rest, ms, init, sim, n) in runs.items():
        card = fused_chunk_card_ms(lambda: sl.sweep(
            cfg, MAIN_GRID[pol], device="cuda"), n)
        init_ms += init
        sim_ms += sim
        card_ms = None if card is None or card_ms is None else card_ms + card
        print(f"main {pol}: of its {ms:.1f} ms wall, init_sweep {init:.1f} "
              f"ms, simulate {sim:.1f} ms: fused_chunk on the card "
              f"{card_text(card, '.1f')} ms ("
              f"{card_text(card and card / n)} ms a launch), outside the "
              f"kernel {card_text(card and sim - card, '.1f')} ms",
              flush=True)
    print(f"main path: {sum(len(r[1].events) for r in runs.values())} "
          f"cells, {total_ev} events in {total_ms / 1e3:.3f} s "
          f"({total_ev / (total_ms / 1e3):.0f} events/s), {launches} "
          f"fused_chunk launches ({total_over} past the last live chunk; "
          f"liveness checked once per {sl.LIVENESS_GROUP}); init_sweep "
          f"{init_ms:.1f} ms, simulate {sim_ms:.1f} ms, of it fused_chunk "
          f"{card_text(card_ms, '.1f')} ms on the card (profiler) and "
          f"outside the kernel {card_text(card_ms and sim_ms - card_ms, '.1f')}"
          f" ms; max_memory_allocated "
          f"{peak / 2**30:.3f} GiB", flush=True)
    if launches <= 0:
        raise AssertionError("the main path launched no fused_chunk kernel")
    return {"launches": launches, "wall_s": total_ms / 1e3,
            "events_per_s": total_ev / (total_ms / 1e3),
            "launches_past_end": total_over, "init_sweep_ms": init_ms,
            "simulate_ms": sim_ms, "card_ms": card_ms,
            "outside_ms": None if card_ms is None else sim_ms - card_ms}


def figure_run(sl, simstep, name, cfg, axes, slo_us, product) -> tuple:
    """One figure grid through ``sweep``'s two parts on the card, held to
    its reference digest; -> (its numbers, its summaries)."""
    import numpy as np
    import torch
    cfg = sl.sweep_config(cfg, axes)
    n0 = simstep.fused_chunk.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tb, pm, st, grid = sl.init_sweep(cfg, axes, slo_us=slo_us,
                                     product=product, device="cuda")
    before = clone(st)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sl.simulate(cfg, tb, pm, st)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n = simstep.fused_chunk.launches - n0
    ev = st.events.cpu().numpy()
    got = full_digest(sl.to_reference(st))
    # The same sweep again under the profiler, not counted.
    card = fused_chunk_card_ms(lambda: sl.sweep(
        cfg, axes, slo_us=slo_us, product=product, device="cuda"), n)
    simstep.fused_chunk.launches = n0 + n
    bound, by = launch_bound(tb, pm, cfg, simstep, before, st, n)
    wall = t2 - t0
    row = {"cells": int(ev.size), "events": int(ev.sum()), "wall_s": wall,
           "init_sweep_ms": (t1 - t0) * 1e3,
           "simulate_ms": (t2 - t1) * 1e3, "events_per_s": ev.sum() / wall,
           "launches": n, "card_ms": card,
           "ms": None if card is None else card / n,
           "bound_ms": bound, "bound_by": by,
           "instantiation": simstep.instantiation_name(cfg)}
    same = got == FIGURE_DIGESTS.get(name)
    print(f"figure {name}: {row['cells']} cells, {row['events']} events, "
          f"{wall:.3f} s ({row['init_sweep_ms']:.1f} ms init_sweep, "
          f"{row['simulate_ms']:.1f} ms simulate), "
          f"{row['events_per_s']:.0f} events/s, {n} launches "
          f"({row['instantiation']}), fused_chunk on the card "
          f"{card_text(card, '.2f')} ms ({card_text(row['ms'])} ms a launch, "
          f"bound {bound:.6f} by {by}); "
          f"{'bit-identical to' if same else 'DIFFERS from'} the JAX "
          f"reference (sha256 {got[:16]})", flush=True)
    if not same:
        raise AssertionError(f"figure {name}: final state differs from JAX")
    horizon = pm.horizon.cpu().numpy()
    if (ev <= 0).any() or (st.t.cpu().numpy() >= horizon).any() or n <= 0:
        raise AssertionError(f"figure {name}: a cell retired no event or "
                             f"ran past its horizon, or no launch")
    summ = sl.sweep_summaries(cfg, st, grid, slo_us=slo_us)
    for s in summ:
        keys = ["throughput_cs_per_s"] + (
            ["energy_j", "power_w", "tput_per_watt"] if sl._energy_on(cfg)
            else [])
        if not all(k in s and np.isfinite(s[k]) and s[k] > 0 for k in keys):
            raise AssertionError(f"figure {name}: bad summary {s}")
    return row, summ


def phase_figures(sl, simstep) -> dict:
    """Phase 3b: the figure grids at full length, each held to the JAX
    package's final state; the launch counter set to 0 just before and
    read just after."""
    from repro_torch.core import energy
    simstep.fused_chunk.launches = 0
    rows = {}
    grids = figure_grids(sl, energy)
    for i, (name, cfg, axes, slo, product) in enumerate(grids):
        rows[name], summ = figure_run(sl, simstep, name, cfg, axes, slo,
                                      product)
        if i == 0:
            p99 = summ[0]["ep_p99_all_us"]
            print(f"figure bench1 fifo ep_p99_all_us {p99!r} sets phase "
                  f"2's SLOs", flush=True)
            rows_2 = figure_run(sl, simstep, *bench1_phase2(cfg, p99))[0]
            rows[bench1_phase2(cfg, p99)[0]] = rows_2
    launches = simstep.fused_chunk.launches
    total_ev = sum(r["events"] for r in rows.values())
    total_s = sum(r["wall_s"] for r in rows.values())
    print(f"figures: {len(rows)} grids, "
          f"{sum(r['cells'] for r in rows.values())} cells, {total_ev} "
          f"events in {total_s:.3f} s ({total_ev / total_s:.0f} events/s), "
          f"{launches} fused_chunk launches", flush=True)
    if launches <= 0 or launches != sum(r["launches"] for r in
                                        rows.values()):
        raise AssertionError("the figure grids' launches do not add up")
    return {"launches": launches, "grids": rows}


def cut_run(sl, simstep, cut, level3=False) -> None:
    """A load grid's cut (:func:`cut_grid`, :func:`feature_cut`) through
    the kernel and through the plain step on the card: every leaf equal,
    and the kernel's final state equal to the JAX package's
    (``CUT_DIGESTS``, ``KEYSHARD_CUT_DIGESTS``); a ``level3`` cut
    (:func:`diurnal_cut`) has no
    JAX digest and is held to the plain step alone."""
    name, cfg, axes, slo, product = cut
    cfg = sl.sweep_config(cfg, axes)
    tb, pm, st, _ = sl.init_sweep(cfg, axes, slo_us=slo, product=product,
                                  device="cuda")
    ref = clone(st)
    kernel_ms = cuda_ms(lambda: sl.simulate(cfg, tb, pm, st))
    plain_ms = cuda_ms(lambda: sl.simulate(
        cfg, tb, pm, ref, chunk_fn=simstep.fused_chunk_ref))
    bad, _ = leaf_diff(st, ref)
    got = full_digest(sl.to_reference(st))
    same = level3 or got == {**CUT_DIGESTS, **KEYSHARD_CUT_DIGESTS}[name]
    print(f"load {name}: {st.events.numel()} cells, {int(st.events.sum())} "
          f"events, kernel {kernel_ms / 1e3:.3f} s, plain {plain_ms / 1e3:.1f}"
          f" s, differing leaves: {bad or 'none'}; " + (
              f"parity level 3, no JAX digest (sha256 {got[:16]})" if level3
              else f"{'bit-identical to' if same else 'DIFFERS from'} the "
              f"JAX reference (sha256 {got[:16]})"), flush=True)
    if bad or not same:
        raise AssertionError(f"load {name}: kernel != plain or != JAX")


def load_columns(name, summ) -> list:
    """The figure's own columns of a load grid's summaries, one line per
    row of the figure: throughput and epoch P99 (the seed replicas'
    mean, as ``paper_figs._seed_mean`` folds them), the excess over the
    SLO of the histogram P99 / P999 (``excess_tail``), goodput and its
    SLO fraction (``chaos_collapse``)."""
    import numpy as np
    rows = {}
    for s in summ:
        if name.startswith("chaos"):
            key = f"pr{float(s['preempt_rate']):g}"
        else:
            key = f"{s['policy']}/r{float(s['arrival_rate']):.4f}"
        rows.setdefault(key, []).append(s)
    lines = []
    for key, grp in rows.items():
        def mean(k):
            v = np.asarray([g[k] for g in grp], float)
            v = v[np.isfinite(v)]
            return float(v.mean()) if v.size else float("nan")
        line = (f"{name} {key}: throughput_cs_per_s "
                f"{mean('throughput_cs_per_s'):.1f} ep_p99_all_us "
                f"{mean('ep_p99_all_us'):.2f}")
        if name == "excess_tail":
            slo = LOAD_SLO["excess"]
            p99, p999 = mean("ep_p99_hist_all_us"), mean("ep_p999_hist_all_us")
            line += (f" ep_p99_hist_us {p99:.2f} ep_p999_hist_us {p999:.2f} "
                     f"excess_p99 {max(0.0, p99 / slo - 1.0):.4f} "
                     f"excess_p999 {max(0.0, p999 / slo - 1.0):.4f}")
        if name.startswith("chaos"):
            line += (f" goodput_eps {mean('goodput_eps'):.1f} "
                     f"slo_good_frac {mean('slo_good_frac'):.4f}")
        lines.append(line)
    return lines


def phase_load_figures(sl, simstep) -> dict:
    """Phase 3c: the load, excess-tail and chaos figures (their cuts,
    kernel against plain step, run in :func:`run_plain_jobs`): the full
    grids through ``sweep``'s two parts, each held to the JAX package's
    final state, with the ``fused_chunk`` counter set to 0 just before
    and read just after."""
    grids = load_grids(sl)
    simstep.fused_chunk.launches = 0
    rows = {}
    for name, cfg, axes, slo, product in grids:
        rows[name], summ = figure_run(sl, simstep, name, cfg, axes, slo,
                                      product)
        for line in load_columns(name, summ):
            print(f"  {line}", flush=True)
    launches = simstep.fused_chunk.launches
    total_ev = sum(r["events"] for r in rows.values())
    total_s = sum(r["wall_s"] for r in rows.values())
    print(f"load figures: {len(rows)} grids, "
          f"{sum(r['cells'] for r in rows.values())} cells, {total_ev} "
          f"events in {total_s:.3f} s ({total_ev / total_s:.0f} events/s), "
          f"{launches} fused_chunk launches", flush=True)
    if launches <= 0 or launches != sum(r["launches"] for r in
                                        rows.values()):
        raise AssertionError("the load grids' launches do not add up")
    return {"launches": launches, "grids": rows}


def phase_keyshard(sl, simstep) -> dict:
    """Phase 3d: keyed traffic (its comparisons of kernel and plain step,
    the keyed cuts held to ``KEYSHARD_CUT_DIGESTS`` and each ks_* policy
    with keys off, run in :func:`run_plain_jobs`):
    ``paper_figs.keyshard`` at full length through
    ``sweep``'s two parts, each grid held to the JAX package's final state,
    with the ``fused_chunk`` counter set to 0 just before and read just
    after; each cell's throughput and epoch P99 by label."""
    t0 = time.time()
    simstep.fused_chunk.launches = 0
    rows = {}
    for name, cfg, axes, slo, product in keyshard_grids(sl):
        rows[name], summ = figure_run(sl, simstep, name, cfg, axes, slo,
                                      product)
        for c in summ:
            print(f"  {name}/th{float(c['zipf_theta']):g}"
                  f"_l{int(c['n_locks'])}: throughput_cs_per_s "
                  f"{c['throughput_cs_per_s']:.1f} ep_p99_all_us "
                  f"{c['ep_p99_all_us']:.2f}", flush=True)
    launches = simstep.fused_chunk.launches
    total_ev = sum(r["events"] for r in rows.values())
    total_s = sum(r["wall_s"] for r in rows.values())
    cards = [r["card_ms"] for r in rows.values()]
    card = None if None in cards else sum(cards)
    print(f"keyshard figure: {len(rows)} grids, "
          f"{sum(r['cells'] for r in rows.values())} cells, {total_ev} "
          f"events in {total_s:.3f} s ({total_ev / total_s:.0f} events/s), "
          f"{launches} fused_chunk launches, {card_text(card, '.2f')} ms on "
          f"the card ({card_text(card and card / launches)} ms a launch); "
          f"phase 3d "
          f"{time.time() - t0:.1f} s", flush=True)
    if launches <= 0 or launches != sum(r["launches"] for r in
                                        rows.values()):
        raise AssertionError("the keyshard grids' launches do not add up")
    return {"launches": launches, "grids": rows}


def carried_run(sl, simstep, name, cfg, windows) -> tuple:
    """One of Bench-2's runs (``run`` with ``windows0`` carried) on the
    card, held to the JAX package's final state; -> (its numbers, its
    final state)."""
    import torch
    n0 = simstep.fused_chunk.launches
    w_in = None if windows is None else windows.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = sl.run(cfg, BENCH2_SLO, 0, windows, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = simstep.fused_chunk.launches - n0
    got = full_digest(sl.to_reference(st))
    card = fused_chunk_card_ms(lambda: sl.run(
        cfg, BENCH2_SLO, 0, w_in, device="cuda"), n)
    simstep.fused_chunk.launches = n0 + n
    ev = int(st.events)
    row = {"cells": 1, "events": ev, "wall_s": wall,
           "events_per_s": ev / wall, "launches": n, "card_ms": card,
           "ms": None if card is None else card / n,
           "instantiation": cfg.policy}
    same = got == FIGURE_DIGESTS[name]
    mean_w = float(st.window[4:].mean()) / 100.0
    print(f"figure {name}: 1 cell, {ev} events, {wall:.3f} s, "
          f"{row['events_per_s']:.0f} events/s, {n} launches, fused_chunk "
          f"on the card {card_text(card, '.2f')} ms "
          f"({card_text(row['ms'])} ms a launch); little "
          f"cores' mean window {mean_w:.2f} us; "
          f"{'bit-identical to' if same else 'DIFFERS from'} the JAX "
          f"reference (sha256 {got[:16]})", flush=True)
    if not same or ev <= 0 or n <= 0:
        raise AssertionError(f"figure {name}: final state differs from JAX, "
                             f"or no event or launch")
    return row, st


def phase_closed(sl, simstep) -> dict:
    """Phase 3e: the six closed-loop figures at full length, each grid
    (and each of Bench-2's carried runs) held to the JAX package's final
    state, with the ``fused_chunk`` counter set to 0 just before and read
    just after."""
    t0 = time.time()
    simstep.fused_chunk.launches = 0
    rows, tas_p99 = {}, None
    for name, cfg, axes, slo, product in closed_grids(sl):
        rows[name], summ = figure_run(sl, simstep, name, cfg, axes, slo,
                                      product)
        if name == "bench4 tas":
            tas_p99 = [s["ep_p99_all_us"] for s in summ]
    b4 = bench4_phase2(sl, tas_p99)
    rows[b4[0]], _ = figure_run(sl, simstep, *b4)
    windows = None
    for name, cfg in bench2_phases(sl):
        rows[name], st = carried_run(sl, simstep, name, cfg, windows)
        windows = st.window
    launches = simstep.fused_chunk.launches
    total_ev = sum(r["events"] for r in rows.values())
    total_s = sum(r["wall_s"] for r in rows.values())
    print(f"closed-loop figures: {len(rows)} grids and runs, "
          f"{sum(r['cells'] for r in rows.values())} cells, {total_ev} "
          f"events in {total_s:.3f} s ({total_ev / total_s:.0f} events/s), "
          f"{launches} fused_chunk launches; phase 3e {time.time() - t0:.1f}"
          f" s", flush=True)
    if launches <= 0 or launches != sum(r["launches"] for r in
                                        rows.values()):
        raise AssertionError("the closed-loop grids' launches do not add up")
    return {"launches": launches, "grids": rows, "bench4 libasl": b4}


def resume_case(sl, name, cfg, axes, slo, product, want) -> tuple:
    """A grid's one-shot sweep (held to its JAX digest ``want``), then
    resumable in each of RESUME_CHUNKS' slices, its last slices'
    checkpoints deleted and resumed, each bit-equal to the one-shot, and
    split over ``cuda:0`` in each of SPLITS, bit-equal too; -> (the
    one-shot state, a resume directory of the grid)."""
    import math
    import shutil
    import tempfile
    one, _ = sl.sweep(cfg, axes, slo_us=slo, product=product, device="cuda")
    got = full_digest(sl.to_reference(one))
    n_cells = one.t.shape[0]
    k0 = len(sl.sweep_log())
    print(f"api {name}: {n_cells} cells, one-shot {sl.sweep_log()[-1]} "
          f"{'bit-identical to' if got == want else 'DIFFERS from'} the JAX "
          f"reference (sha256 {got[:16]})", flush=True)
    if got != want:
        raise AssertionError(f"api {name}: one-shot sweep differs from JAX")
    kept = None
    for chunk in RESUME_CHUNKS:
        d = Path(tempfile.mkdtemp(prefix="repro_torch_resume_"))
        n_slices = math.ceil(n_cells / chunk)
        k0 = len(sl.sweep_log())
        st, _ = sl.sweep(cfg, axes, slo_us=slo, product=product,
                         device="cuda", resume_dir=d, resume_chunk=chunk)
        whole = sl.sweep_log()[k0:]
        bad, _ = leaf_diff(st, one)
        cut = max(1, n_slices // 2)
        for k in range(n_slices - cut, n_slices):
            shutil.rmtree(d / f"step_{k}")
        k0 = len(sl.sweep_log())
        st, _ = sl.sweep(cfg, axes, slo_us=slo, product=product,
                         device="cuda", resume_dir=d, resume_chunk=chunk)
        resumed = sl.sweep_log()[k0:]
        bad2, _ = leaf_diff(st, one)
        print(f"api {name} resumable, chunks of {chunk}: {n_slices} slices, "
              f"{sum(r['launches'] for r in whole)} launches "
              f"({[r['launches'] for r in whole]}), differing leaves: "
              f"{bad or 'none'}; {cut} slices' checkpoints deleted and "
              f"resumed: {len(resumed)} slices run, "
              f"{sum(r['launches'] for r in resumed)} launches, differing "
              f"leaves: {bad2 or 'none'}", flush=True)
        if bad or bad2 or len(resumed) != cut:
            raise AssertionError(f"api {name}: resumed sweep != one-shot")
        if kept is None:
            kept = d
        else:
            shutil.rmtree(d, ignore_errors=True)
    for k in SPLITS:
        k0 = len(sl.sweep_log())
        st, _ = sl.sweep(cfg, axes, slo_us=slo, product=product,
                         devices=["cuda:0"] * k)
        rec = sl.sweep_log()[k0]
        bad, _ = leaf_diff(st, one)
        print(f"api {name} split over {k} x cuda:0: {rec['n_cells']} cells "
              f"padded, {rec['launches']} launches, differing leaves: "
              f"{bad or 'none'}", flush=True)
        if bad or rec["devices"] != k:
            raise AssertionError(f"api {name}: split sweep != unsplit")
    return one, kept


def phase_api(sl, simstep, closed) -> dict:
    """Phase 3f: the simulator's API on the card, with the ``fused_chunk``
    counter set to 0 just before and read just after.  Resumable and
    split sweeps of Bench-4's libasl grid and of the loadlat cut
    (:func:`resume_case`); a directory that holds another sweep refused;
    ``sweep_slo`` over Figure 8b's SLOs and the ``amp_config`` grid, each
    held to its JAX digest; fig1's registered policies one executable
    each; the phase's ``sweep_log()`` and ``executable_records()``."""
    import shutil
    import torch
    from repro_torch.core.policies import REGISTRY
    from repro_torch.workloads import clients, generators
    t0 = time.time()
    simstep.fused_chunk.launches = 0
    k_start, e_start = len(sl.sweep_log()), sl.n_batch_executables()
    _, cfg, axes, slo, product = closed["bench4 libasl"]
    _, b4_dir = resume_case(sl, "bench4 libasl", cfg, axes, slo, product,
                            FIGURE_DIGESTS["bench4 libasl"])
    name, cfg2, axes2, slo2, product2 = cut_grid(load_grids(sl)[0])
    _, cut_dir = resume_case(sl, name, cfg2, axes2, slo2, product2,
                             CUT_DIGESTS[name])
    try:
        sl.sweep(cfg2, axes2, slo_us=slo2, product=product2, device="cuda",
                 resume_dir=b4_dir, resume_chunk=RESUME_CHUNKS[0])
    except ValueError as e:
        print(f"api: the loadlat cut resumed into Bench-4's directory "
              f"refused: {e}", flush=True)
    else:
        raise AssertionError("a resume_dir of another sweep was not refused")
    finally:
        shutil.rmtree(b4_dir, ignore_errors=True)
        shutil.rmtree(cut_dir, ignore_errors=True)
    st = sl.sweep_slo(fig8b_cfg(sl), FIG8B_SLOS, device="cuda")
    got = full_digest(sl.to_reference(st))
    same = got == FIGURE_DIGESTS["figure8b sweep_slo"]
    print(f"api sweep_slo, Figure 8b's {len(FIG8B_SLOS)} SLOs: "
          f"{sl.sweep_log()[-1]}; {'bit-identical to' if same else 'DIFFERS from'}"
          f" the JAX reference (sha256 {got[:16]})", flush=True)
    if not same:
        raise AssertionError("sweep_slo differs from JAX")
    amp = amp_grid(sl, clients, generators)
    amp_row, summ = figure_run(sl, simstep, *amp)
    print(f"  amp_config columns: slo_scale {amp[1].slo_scale}, "
          f"wl_service_per_core {amp[1].wl_service_per_core}", flush=True)
    # fig1's registered policies: one executable each, none on a repeat.
    grids = [(p, fig_cfg(sl, p, **FIG1_KW.get(p, {})), FIG1_SLO.get(p, 1e9))
             for p in REGISTRY]
    k0 = len(sl.sweep_log())
    for _, cfg, slo in grids:
        sl.sweep(cfg, {"n_cores": list(range(1, 9))}, slo_us=slo,
                 device="cuda")
    recs = sl.sweep_log()[k0:]
    n1 = sl.n_batch_executables()
    for _, cfg, slo in grids:
        sl.sweep(cfg, {"n_cores": list(range(1, 9))}, slo_us=slo,
                 device="cuda")
    names = [r["instantiation"] for r in recs]
    print(f"api fig1's {len(grids)} registered policies: instantiations "
          f"{names}; executables loaded {n1}, after the same ten sweeps "
          f"again {sl.n_batch_executables()}", flush=True)
    if len(set(names)) != len(grids) or sl.n_batch_executables() != n1:
        raise AssertionError("fig1's registered policies do not load one "
                             "executable each")
    torch.cuda.synchronize()
    launches = simstep.fused_chunk.launches
    log = sl.sweep_log()[k_start:]
    print(f"api sweep_log(): {len(log)} records this phase", flush=True)
    for r in log:
        print(f"  {r}")
    execs = sl.executable_records()[e_start:]
    print(f"api executable_records(): {len(execs)} loaded this phase, "
          f"{sl.n_batch_executables()} in all", flush=True)
    for r in execs:
        print(f"  {r}")
    print(f"api: {launches} fused_chunk launches; phase 3f "
          f"{time.time() - t0:.1f} s", flush=True)
    if launches <= 0:
        raise AssertionError("phase 3f launched no fused_chunk kernel")
    return {"launches": launches, "amp": amp_row}


def phase_example() -> None:
    """Phase 3g: ``examples/lock_microbench_torch.py`` once, in its own
    process, on the card: it must exit 0, print its six tables and
    report ``fused_chunk`` launches."""
    cmd = [sys.executable, "examples/lock_microbench_torch.py"]
    print("$ " + " ".join(cmd[1:]), flush=True)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ,
                                           "PYTHONPATH": str(ROOT / "src")})
    for line in res.stdout.splitlines():
        print(f"  {line}")
    wall = time.perf_counter() - t0
    print(f"  (exit {res.returncode} in {wall:.1f} s; phase 3g)", flush=True)
    tables = sum(line.startswith("==") for line in res.stdout.splitlines())
    launched = [int(line.split()[-1]) for line in res.stdout.splitlines()
                if line.startswith("fused_chunk launches:")]
    if res.returncode != 0 or tables != 6 or not launched or \
            launched[0] <= 0:
        print(res.stderr[-4000:], file=sys.stderr)
        raise AssertionError("examples/lock_microbench_torch.py failed")


def phase_fleet() -> dict:
    """Phase 3h: ``examples/serving_bench_torch.py``'s four sections (the
    fleet dispatcher over every dispatch policy and load, the serving
    engine's two sections and the staleness simulation; host-side numpy)
    at ``SCALE = 1.0``, each section's rows held to the JAX package's
    (``FLEET_DIGESTS``).  -> {section: seconds}."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "serving_bench_torch", ROOT / "examples" / "serving_bench_torch.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    secs = {}
    for name, section in bench.ALL.items():
        t0 = time.perf_counter()
        rows = section()
        secs[name] = round(time.perf_counter() - t0, 3)
        got = bench.rows_digest(rows)
        ok = got == FLEET_DIGESTS[name]
        print(f"fleet {name}: {len(rows)} rows in {secs[name]} s, digest "
              f"{got[:16]}... {'== the JAX package' if ok else 'DIFFERS'}",
              flush=True)
        for row in rows:
            if name == "dispatch_fleet":
                print(f"  {row['name']}: throughput "
                      f"{row['throughput_rps']:.3f} rps, p99 "
                      f"{row['p99']:.4f} s, fast {row['served_fast']} / "
                      f"slow {row['served_slow']}")
        if not ok:
            raise AssertionError(f"fleet section {name} differs from the "
                                 f"JAX package's rows")
    return secs


def mlstm_inputs(gen, b, h, s, dh, dtype, carry, model_layout=False):
    """Random q, k (scaled by 1/sqrt(dh)), v in ``dtype``, f32 gates (the
    forget gate biased open, as the model initializes it) and, if asked,
    a positive f32 carry, all on the card.  ``model_layout``: q, k, v and
    the gates are the model's [B,S,H,*] tensors, handed over as
    transposed [B,H,S,*] views."""
    import torch
    f = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    if model_layout:
        g = lambda *shape: f(b, s, h, *shape[3:]).transpose(1, 2)
    else:
        g = f
    q, k, v = g(b, h, s, dh), g(b, h, s, dh) / dh ** 0.5, g(b, h, s, dh)
    args = [t.to(dtype) for t in (q, k, v)] + [g(b, h, s), g(b, h, s) + 2.0]
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


def bit_equal(a, b) -> bool:
    """Two results (tensors, or tuples of them) equal bit for bit."""
    import torch
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if a is None or b is None:
        return a is b
    return all(bit_equal(x, y) for x, y in zip(a, b))


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


def phase_mlstm(ms, build) -> dict:
    """mlstm_scan == its plain version on the card over the listed cases
    (two calls bit-equal), the launch plan and ptxas's spills; then the
    serving prefill and decode shapes, as the model calls the kernel
    (f32, transposed views), timed against their bounds."""
    import torch
    spilled = spills(build, "mlstm_scan")
    print(f"mlstm_scan spill bytes (ptxas): {spilled}", flush=True)
    if not spilled or any(spilled.values()):
        raise AssertionError("mlstm_scan spills registers")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n_bad = n_cases = 0
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for dh in (32, 192):
            for s in (1, 7, 15, 16, 17, 256):
                for carry in (False, True):
                    for layout in (False, True):
                        args, c = mlstm_inputs(gen, 2, 4, s, dh, dtype,
                                               carry, layout)
                        n0 = ms.mlstm_scan.launches
                        got = ms.mlstm_scan(*args, c)
                        again = ms.mlstm_scan(*args, c)
                        torch.cuda.synchronize()
                        want = ms.mlstm_scan_ref(*args, c)
                        errs, ok = mlstm_diff(got, want, dname)
                        same = bit_equal(got, again)
                        ok = ok and same and ms.mlstm_scan.launches == n0 + 2
                        n_cases += 1
                        n_bad += not ok
                        print(f"mlstm_scan {dname} B=2 H=4 S={s} dh={dh} "
                              f"carry={carry} model layout={layout}: max abs "
                              f"err h/C/n/m "
                              f"{' '.join(f'{e:.3g}' for e in errs)}, two "
                              f"calls {'bit-equal' if same else 'DIFFER'} "
                              f"{'ok' if ok else 'OVER TOLERANCE'}",
                              flush=True)
    print(f"mlstm_scan sweep: {n_cases - n_bad}/{n_cases} cases ok",
          flush=True)
    if n_bad:
        raise AssertionError(f"mlstm_scan != plain version in {n_bad} cases")
    b, h, s, dh = SERVE_BATCH, 4, SERVE_CHUNK, 192
    plans = {n: ms.launch_plan(b, h, n, dh, 4) for n in (s, 1)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"mlstm_scan launch plans at B={b} H={h} dh={dh} f32 (S={s}; "
          f"S=1): {plans[s]}; {plans[1]}; {sms} SMs", flush=True)
    if any(pl.blocks < sms for pl in plans.values()):
        raise AssertionError("mlstm_scan gives fewer blocks than SMs")
    # The serving prefill: a chunk of the calibration, as the model calls
    # the kernel (f32 q, k, v and gates, transposed views, no carry).
    args, _ = mlstm_inputs(gen, b, h, s, dh, torch.float32, False, True)
    kernel_ms, times = median_ms(lambda: ms.mlstm_scan(*args), reps=10)
    _, card_ms, _ = device_busy(lambda: ms.mlstm_scan(*args), 10)
    got = ms.mlstm_scan(*args)
    out = {}
    plain_ms = cuda_ms(lambda: out.update(want=ms.mlstm_scan_ref(*args)))
    errs, ok = mlstm_diff(got, out["want"], "float32")
    bound, by = mlstm_bound(b, h, s, dh, 4, False)
    print(f"mlstm_scan serving prefill B={b} H={h} S={s} dh={dh} f32: "
          f"kernel {kernel_ms:.4f} ms/launch (of "
          f"{[round(t, 4) for t in times]}; on the card "
          f"{card_text(card_ms)}), plain {plain_ms:.2f} ms, bound "
          f"{bound:.5f} ms ({by}), max abs "
          f"err h {errs[0]:.3g}", flush=True)
    if not ok:
        raise AssertionError("mlstm_scan != plain at the serving shapes")
    # The decode shapes: one step from a carry.
    args1, c1 = mlstm_inputs(gen, b, h, 1, dh, torch.float32, True, True)
    dec_ms, _ = median_ms(lambda: ms.mlstm_scan(*args1, c1), reps=100)
    _, dec_card_ms, _ = device_busy(lambda: ms.mlstm_scan(*args1, c1), 100)
    errs1, ok1 = mlstm_diff(ms.mlstm_scan(*args1, c1),
                            ms.mlstm_scan_ref(*args1, c1), "float32")
    dec_bound, dec_by = mlstm_bound(b, h, 1, dh, 4, True)
    print(f"mlstm_scan decode B={b} H={h} S=1 dh={dh} with carry: kernel "
          f"{dec_ms:.4f} ms/launch (on the card {card_text(dec_card_ms)}), "
          f"bound "
          f"{dec_bound:.5f} ms ({dec_by}), max abs err h/C/n/m "
          f"{' '.join(f'{e:.3g}' for e in errs1)}", flush=True)
    if not ok1:
        raise AssertionError("mlstm_scan != plain at the decode shapes")
    return {"ms": kernel_ms, "card_ms": card_ms, "plain_ms": plain_ms,
            "max_abs_err": errs[0], "bound_ms": bound, "bound_by": by,
            "blocks": plans[s].blocks, "decode": {
                "ms": dec_ms, "card_ms": dec_card_ms,
                "max_abs_err": errs1[0], "bound_ms": dec_bound,
                "bound_by": dec_by, "blocks": plans[1].blocks}}


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
    ms.mlstm_scan.launches = ms.mlstm_scan.launches_decode = 0
    out = serve.main(["--arch", ARCH, "--scheduler", *SCHEDULERS]
                     + SERVE_ARGS)
    launches = ms.mlstm_scan.launches
    decode = ms.mlstm_scan.launches_decode
    check_serve_runs(ARCH, n, cfg.dtype, out, out["by_scheduler"])
    print(f"serve: {launches} mlstm_scan launches (one calibration): "
          f"{launches - decode} prefill, {decode} decode (S=1)", flush=True)
    if launches - decode <= 0 or decode <= 0:
        raise AssertionError("the serving path left a shape of mlstm_scan "
                             "unlaunched")
    return {"launches": launches, "by_shape": {
        f"prefill (S={SERVE_CHUNK})": launches - decode,
        "decode (S=1)": decode}}


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


def bound(n_bytes, flops, ops_per_s=BF16_OPS_PER_S) -> tuple:
    """The least time of the work: bytes over the memory rate or
    operations over their peak (bf16 tensor cores unless given), the
    larger."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / ops_per_s * 1e3
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
    tc0 = fa.flash_attention.launches_tc
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    seen = torch.isfinite(want)          # rows with no valid key are NaN
    a, w, tol = got.float()[seen], want.float()[seen], attn_tol(dtype)
    err = float((a - w).abs().max()) if a.numel() else 0.0
    ok = (torch.allclose(a, w, atol=tol, rtol=tol)
          and bool(torch.isfinite(got).all())
          and fa.flash_attention.launches == n0 + 1
          and fa.flash_attention.launches_tc == tc0 + (dtype ==
                                                       torch.bfloat16)
          and got.shape == q.shape and got.dtype == q.dtype)
    return err, ok


# (H, K, dh) of the sweeps: GQA groups 1 and 8 at head dims 64, 128 and
# 256, and recurrentgemma-2b's 10 q heads on one kv head of 256.  S, T of
# the flash sweep: the first port's, then the edges of the tensor-core
# route's 64-row tiles.
FLASH_HEADS = [(8, 8 // g, dh) for dh in (64, 128, 256) for g in (1, 8)] \
    + [(10, 1, 256)]
FLASH_LENGTHS = ((128, 128), (200, 200), (1, 200), (200, 1), (77, 300),
                 (63, 65), (64, 129), (129, 64), (1, 4096))
DECODE_HEADS = [(32, 32 // g, dh) for dh in (64, 128, 256) for g in (1, 8)] \
    + [(10, 1, 256)]


def flash_timing(fa, gen, name, b, h, kh, s, dh, window) -> dict:
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
    print(f"flash_attention {name} B={b} H={h} K={kh} S=T={s} dh={dh} "
          f"window={window} bf16 causal: kernel {kernel_ms:.4f} ms/launch (of "
          f"{[round(x, 4) for x in times]}; on the card "
          f"{card_text(dev_ms)}), "
          f"plain {plain_ms:.3f} ms, "
          f"library {lib_ms:.4f} ms, bound {bnd:.5f} ms ({by}; "
          f"{n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), max abs err "
          f"{err:.3g}; PERF.md row before the tensor-core route "
          f"{EARLIER_MS.get('flash_attention ' + name, 'none')} ms",
          flush=True)
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
    n_tc0, n_all0 = fa.flash_attention.launches_tc, \
        fa.flash_attention.launches
    for dtype in (torch.float32, torch.bfloat16):
        for h, kh, dh in FLASH_HEADS:
            for s, t in FLASH_LENGTHS:
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
          f"S,T in {' '.join(f'{a}/{b}' for a, b in FLASH_LENGTHS)} x "
          f"causal x window 0/64); tensor-core launches "
          f"{fa.flash_attention.launches_tc - n_tc0} of "
          f"{fa.flash_attention.launches - n_all0}", flush=True)
    if n_bad:
        raise AssertionError(f"flash_attention != plain in {n_bad} cases")
    yi = flash_timing(fa, gen, f"{YI} serve", SERVE_BATCH, 32, 4,
                      SERVE_CHUNK, 128, 0)
    flash_timing(fa, gen, f"{RG} serve", SERVE_BATCH, 10, 1, SERVE_CHUNK,
                 256, 2048)
    return yi


def decode_case(da, gen, b, h, kh, t, dh, dtype, lengths,
                starts=None) -> tuple:
    """The wrapper's split and one forced split, each one launch against
    the plain version, the caches as transposed views of [B,T,K,dh] (the
    model's layout); a row of length 0 must come out zeros (the plain
    version gives NaN there).  -> (max abs err, ok)."""
    import torch
    f = lambda *shape: torch.randn(*shape, generator=gen, device="cuda") \
        .to(dtype)
    q = f(b, h, dh)
    kc, vc = (f(b, t, kh, dh).transpose(1, 2) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if starts is not None:
        starts = torch.tensor(starts, dtype=torch.int32, device="cuda")
    want = da.decode_attention_ref(q, kc, vc, lens, starts).float()
    seen = torch.isfinite(want)
    tol = attn_tol(dtype)
    err, ok = 0.0, True
    for splits in (None, 1):
        n0 = da.decode_attention.launches
        got = da.decode_attention(q, kc, vc, lens, starts, splits=splits)
        torch.cuda.synchronize()
        a = got.float()
        if seen.any():
            err = max(err, float((a[seen] - want[seen]).abs().max()))
        ok = ok and (torch.allclose(a[seen], want[seen], atol=tol, rtol=tol)
                     and bool((a[~seen] == 0).all())
                     and da.decode_attention.launches == n0 + 1
                     and got.shape == q.shape and got.dtype == q.dtype)
    return err, ok


def decode_plan(da, b, h, kh, t, dh, esize) -> tuple:
    """(splits, blocks) the wrapper takes at a shape on this card."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = da.plan_splits(b, kh, t, h // kh, dh, esize, sms)
    return splits, splits * kh * b


def decode_timing(da, gen, b, h, kh, t, dh, n, starts) -> dict:
    """One decode shape in bf16 with ``n`` valid slots of every row (ring
    starts: None or zeros), the caches as the model's views: the kernel
    timed against its bound, the plain version and PyTorch's fused
    attention on the valid prefix; two calls bit-equal; then the
    wrapper's split against one forced split (``splits=1``), in turns
    (split, unsplit, unsplit, split)."""
    import torch
    f = lambda *shape: torch.randn(*shape, generator=gen, device="cuda") \
        .to(torch.bfloat16)
    q = f(b, h, dh)
    kc, vc = (f(b, t, kh, dh).transpose(1, 2) for _ in range(2))
    lens = torch.full((b,), n, dtype=torch.int32, device="cuda")
    st = None if starts is None else \
        torch.full((b,), starts, dtype=torch.int32, device="cuda")
    splits, blocks = decode_plan(da, b, h, kh, t, dh, 2)
    kernel_ms, times = median_ms(
        lambda: da.decode_attention(q, kc, vc, lens, st), reps=100)
    got = da.decode_attention(q, kc, vc, lens, st)
    again = da.decode_attention(q, kc, vc, lens, st)
    out = {}
    plain_ms = cuda_ms(lambda: out.update(
        want=da.decode_attention_ref(q, kc, vc, lens, st)))
    err = float((got.float() - out["want"].float()).abs().max())
    q4 = q[:, :, None]
    kv, vv = (x[:, :, :n].contiguous() for x in (kc, vc))
    lib_ms, _ = median_ms(lambda: library_attention(q4, kv, vv, False),
                          reps=100)
    _, lib_dev_ms, _ = device_busy(
        lambda: library_attention(q4, kv, vv, False), 100)
    _, dev_ms, _ = device_busy(
        lambda: da.decode_attention(q, kc, vc, lens, st), 100)
    by_kernel = kernel_split(
        lambda: da.decode_attention(q, kc, vc, lens, st), 100)
    n_bytes = 2 * (2 * q.numel() + 2 * b * kh * n * dh)
    flops = 2 * 2 * b * h * n * dh
    bnd, by = bound(n_bytes, flops)
    turns = {}
    for name in ("split", "unsplit", "unsplit", "split"):
        force = 1 if name == "unsplit" else None
        ms, _ = median_ms(lambda: da.decode_attention(
            q, kc, vc, lens, st, splits=force), reps=100)
        _, card, _ = device_busy(lambda: da.decode_attention(
            q, kc, vc, lens, st, splits=force), 100)
        turns.setdefault(name, []).append(
            (round(ms, 4), None if card is None else round(card, 4)))
    print(f"decode_attention B={b} H={h} K={kh} T={t} length {n} starts "
          f"{starts} dh={dh} bf16: kernel {kernel_ms:.4f} ms/launch (of "
          f"{[round(x, 4) for x in times]}; on the card "
          f"{card_text(dev_ms)}: "
          f"{by_kernel and {k: round(v, 4) for k, v in by_kernel.items()}}"
          f"), plain {plain_ms:.3f} ms, library {lib_ms:.4f} ms (on the card "
          f"{card_text(lib_dev_ms)}), bound {bnd:.6f} ms "
          f"({by}; {n_bytes / 1e6:.2f} MB), {splits} splits x {kh * b} = "
          f"{blocks} blocks, max abs err {err:.3g}, two calls "
          f"{'bit-equal' if torch.equal(got, again) else 'DIFFER'}; in "
          f"turns (ms/launch, on the card): split {turns['split']}, "
          f"unsplit (one block per row and kv head, {kh * b} blocks) "
          f"{turns['unsplit']}", flush=True)
    if err > attn_tol(torch.bfloat16) or not torch.equal(got, again):
        raise AssertionError(f"decode_attention != plain or not "
                             f"deterministic at B={b} H={h} K={kh} T={t} "
                             f"dh={dh}")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "max_abs_err": err,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
            "library_card_ms": lib_dev_ms, "card_ms": dev_ms,
            "splits": splits, "blocks": blocks,
            "unsplit_ms": min(t[0] for t in turns["unsplit"]),
            "unsplit_card_ms": min((t[1] for t in turns["unsplit"]
                                    if t[1] is not None), default=None)}


# Lengths of the decode sweep: the first port's, and the edges of the
# split kernel's 16- and 32-key pieces and of a row of length 0.
DECODE_LENGTHS = (1, 15, 16, 17, 63, 64, 65, 257)


def phase_decode(da) -> dict:
    """decode_attention == its plain version on the card over the sweep
    (prefix lengths, rows of length 0, ring starts where a local block's
    window drops slots of a wrapped ring, runs that wrap inside a split,
    and recurrentgemma-2b's heads on its local ring of 2,049 slots), each
    case through the wrapper's split and one forced split; then the yi-6b
    and recurrentgemma-2b decode shapes timed against their bounds, the
    plain version, PyTorch's fused attention and the unsplit kernel.  ->
    the yi-6b shape's numbers (the kernel table's), the
    recurrentgemma-2b shape's under "rg"."""
    import torch
    from repro_torch.models import layers
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    n_bad = n_cases = 0

    def case(label, *args):
        nonlocal n_bad, n_cases
        err, ok = decode_case(da, gen, *args)
        n_cases += 1
        n_bad += not ok
        if not ok:
            print(f"decode_attention {label}: max abs err {err:.3g} OVER "
                  f"TOLERANCE", flush=True)
        return err, ok

    for dtype in (torch.float32, torch.bfloat16):
        for h, kh, dh in DECODE_HEADS:
            for t in (512, 300):
                mix = [1, 257, 511, t, 64, 65, 2, t - 1]
                edges = [0, 15, 16, 17, 63, 0, t, 257]
                for lengths in ([1] * 8, [257] * 8, [min(511, t)] * 8,
                                [t] * 8, [min(x, t) for x in mix],
                                [min(x, t) for x in edges],
                                list(DECODE_LENGTHS)):
                    case(f"{dtype} H={h} K={kh} dh={dh} T={t} lengths="
                         f"{lengths}", 8, h, kh, t, dh, dtype, lengths)
                # Ring runs that wrap at T inside a split's positions.
                starts = [t - 10, t - 1, t - 100, 5, t - 3, 0, t // 2,
                          t - 257]
                case(f"{dtype} H={h} K={kh} dh={dh} T={t} wrapped runs",
                     8, h, kh, t, dh, dtype, [257, 2, 200, t, 65, 0, t,
                                              257], starts)
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
                err, ok = case(f"ring T={t} window={window} {dtype} H={h} "
                               f"K={kh} dh={dh} positions {last}", 8, h,
                               kh, t, dh, dtype, lengths, starts)
                if ok and dtype == torch.float32 and h == 10:
                    print(f"decode_attention ring T={t} window={window} "
                          f"{dtype} H={h} K={kh} dh={dh} positions {last} "
                          f"-> lengths {lengths} starts {starts}: max abs "
                          f"err {err:.3g} ok", flush=True)
    # recurrentgemma-2b's local ring (window 2048, 2,049 slots), at
    # positions before and after it wraps.
    t, window = 2049, 2048
    for dtype in (torch.float32, torch.bfloat16):
        for last in ([256] * 8, [2048] * 8, [2049] * 8,
                     [0, 16, 63, 2047, 2048, 2049, 3000, 5000]):
            runs = [layers.decode_run(torch.tensor(x), t, window)
                    for x in last]
            case(f"ring T={t} window={window} {dtype} positions {last}", 8,
                 10, 1, t, 256, dtype, [int(n) for n, _ in runs],
                 [int(st) for _, st in runs])
    plan = {name: decode_plan(da, 8, h, kh, t, dh, 2)
            for name, (h, kh, t, dh) in (
                (YI, (32, 4, 512, 128)), (RG, (10, 1, 512, 256)),
                (f"{RG} ring", (10, 1, 2049, 256)))}
    print(f"decode_attention sweep: {n_cases - n_bad}/{n_cases} cases "
          f"within tolerance, each through the wrapper's split and one "
          f"forced split (f32/bf16 x (H, K, dh) in {DECODE_HEADS} x T "
          f"512/300 x lengths 1, 257, 511, T, a mix, 0 and the split "
          f"edges {DECODE_LENGTHS} per row, and runs that wrap inside a "
          f"split; ring of 17 slots, window 16, at positions 16, 17, 40 "
          f"and a mix; recurrentgemma-2b's heads on its ring of 2,049 "
          f"slots, window 2048); rows of length 0 zeros; (splits, blocks) "
          f"at batch 8: {plan}", flush=True)
    if n_bad:
        raise AssertionError(f"decode_attention != plain in {n_bad} cases")
    b, t, n = SERVE_BATCH, 2 * SERVE_CHUNK, SERVE_CHUNK + 1
    yi = decode_timing(da, gen, b, 32, 4, t, 128, n, None)
    rg = decode_timing(da, gen, b, 10, 1, t, 256, n, 0)
    if min(yi["blocks"], rg["blocks"]) < \
            torch.cuda.get_device_properties(0).multi_processor_count:
        raise AssertionError("a serving decode shape runs fewer blocks "
                             "than the card has SMs")
    return dict(yi, rg=rg)


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
    ``attn_block_decode`` run it (``attn_block_apply`` with no ``cache``),
    cut into segments bracketed by
    synchronisations: the f32 -> bf16 weight casts, the attention
    projections (q, k, v with RoPE, and the output), attention (the cache
    write, the decode mask's run and the kernel), and the FFN (norm,
    gated FFN, residual); a mixture-of-experts FFN in three: routing
    (norm, router, top-k, positions and the scatter into the buffer), the
    expert products, and the combine (with the residual).  Seconds add to
    ``spent``; -> (x, cache)."""
    import torch
    from repro_torch.models import moe
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
        new = None if cache is None else seg("attention", lambda: {
            n: torch.cat([t, cache[n][:, s:]], dim=1)
            for n, t in (("k", k), ("v", v))})
        out = seg("attention", lambda: layers.attention(
            q, k, v, causal=cfg.causal, window=window, dtype=dtype))
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
    if not cfg.n_experts:
        x = seg("ffn", lambda: x + layers.mlp_apply(
            pc["mlp"], layers.rms_norm(x, lp["ln2"], cfg.norm_eps),
            cfg.activation, dtype))
        return x, new
    buf, meta, _ = seg("moe routing", lambda: moe._route_local(
        layers.rms_norm(x, lp["ln2"], cfg.norm_eps).reshape(b * s, -1),
        pc["moe"]["router"], cfg, moe._capacity(b * s, cfg)))
    out_buf = seg("expert products", lambda: moe._expert_ffn(
        pc["moe"], buf, cfg, dtype))
    x = seg("moe combine", lambda: x + moe._combine_local(
        out_buf, meta, dtype).reshape(x.shape))
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


def card_events(events, device_type) -> list:
    """The kernels and copies on the card in a profile's events.  The GPU
    spans of user ranges (the profiler's ``ProfilerStep``, the port's
    ``repro_torch.*``) cover kernels already counted and are left out."""
    return [e for e in events if e.device_type == device_type.CUDA
            and not e.is_user_annotation]


def card_us(events, device_type):
    """Microseconds of kernels and copies on the card in a profile's
    events (:func:`card_events`); None where :func:`profiled` gave no
    complete trace."""
    if events is None:
        return None
    return sum(e.time_range.elapsed_us()
               for e in card_events(events, device_type))


# Traces profiled takes of one thing before it gives up on a card time,
# and the idle host seconds it leaves on each side of the calls it traces.
PROFILE_TRIES = 3
PROFILE_PAD_S = 0.05


def profiled(fn, n, least=None):
    """torch.profiler's events of ``n`` calls of ``fn`` and a
    synchronisation, after as many in a warm-up cycle that the profiler
    traces and throws away: without it, the kernels of the first calls
    after the profiler started could be missing from the trace.  Traces
    of a few milliseconds of work have come back without some or all of
    their kernels, as if the window cut them off at its edges, so each
    cycle leaves ``PROFILE_PAD_S`` of idle time before and after its
    calls.  Each call launches a kernel or more, so a trace with fewer
    kernels and
    copies on the card than calls (or than ``least``, where the caller
    knows more) has lost events (the profiler has returned such traces,
    with some or all of the card's events missing); it is taken again, up
    to ``PROFILE_TRIES`` times.  -> the events of the first
    complete trace, or None: a card time read from an incomplete one
    would be wrong."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(1, PROFILE_TRIES + 1):
        box = {}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: box.update(events=p.events())) \
                as prof:
            for _ in range(2):
                time.sleep(PROFILE_PAD_S)
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                time.sleep(PROFILE_PAD_S)
                prof.step()
        found = len(card_events(box["events"], DeviceType))
        if found >= (n if least is None else least):
            return box["events"]
        print(f"torch.profiler: trace {attempt} of {n} calls holds {found} "
              f"kernels and copies on the card, fewer than launched; "
              f"{'again' if attempt < PROFILE_TRIES else 'not measured'}",
              flush=True)
    return None


def card_text(ms, spec=".4f") -> str:
    """A card time as text; "not measured" for None."""
    return "not measured" if ms is None else format(ms, spec)


def device_busy(fn, n) -> tuple:
    """(wall ms, device ms, idle share) of one call of ``fn``: the card's
    kernel and copy time from ``torch.profiler`` over ``n`` calls (one
    stream, so the events do not overlap), against the wall time of ``n``
    more calls with the profiler off.  The device ms and the idle share
    are None where no complete trace was taken."""
    import torch
    from torch.autograd import DeviceType
    busy = card_us(profiled(fn, n), DeviceType)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    if busy is None:
        return wall, None, None
    busy = busy / 1e3 / n
    return wall, busy, 1 - busy / wall


def kernel_split(fn, n, least=None):
    """ms a call of each kernel that ``fn`` launches, by name (its
    template argument kept), from ``torch.profiler``; None where no
    complete trace was taken (:func:`profiled`)."""
    import re
    from torch.autograd import DeviceType
    events = profiled(fn, n, least)
    if events is None:
        return None
    split = {}
    for e in card_events(events, DeviceType):
        m = re.search(r"\w+_kernel(<\d+>)?", e.name)
        key = m.group(0) if m else e.name[:40]
        split[key] = split.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    return split


def fused_chunk_card_ms(fn, launches):
    """ms on the card of the ``launches`` fused_chunk launches of one
    call of ``fn``; None where no complete trace was taken."""
    split = kernel_split(fn, 1, launches)
    return None if split is None else sum(
        v for k, v in split.items() if "fused_chunk" in k)


@contextlib.contextmanager
def expert_choices(moe, *, record=None, force=None):
    """Within it, each call of ``moe._top_k`` (one a mixture-of-experts
    layer a step) appends to the list ``record`` its expert ids and each
    token's margin, the least gap between neighbours of its k + 1 largest
    probabilities (a smaller one flips its choices or their order); or,
    with
    ``force`` (an iterator over such a list), takes the next ids from it,
    with the gates this call's probabilities at those ids."""
    import torch
    orig = moe._top_k

    def top_k(probs, k):
        if force is not None:
            idx, _ = next(force)
            return probs.gather(-1, idx), idx
        vals, idx = orig(probs, k)
        top = torch.topk(probs, k + 1, dim=-1).values
        record.append((idx.clone(), (top[:, :-1] - top[:, 1:]).amin(-1)))
        return vals, idx
    moe._top_k = top_k
    try:
        yield
    finally:
        moe._top_k = orig


def routing_flips(a, b, n_layers) -> tuple:
    """Two paths' records (:func:`expert_choices`) compared: (differing,
    all) (token, layer, choice) expert ids, apart for the prefill (its
    first ``n_layers`` calls) and the decode steps; and where they first
    differ (the first call, with the same ids at every layer before it,
    so only the attention paths' difference reached it): (the call, the
    tokens that differ, the largest margin of those tokens in either
    path, the median margin of all tokens there), or None."""
    import torch
    out = {}
    for name, sl in (("prefill", slice(0, n_layers)),
                     ("decode", slice(n_layers, None))):
        pairs = list(zip(a[sl], b[sl]))
        out[name] = (sum(int((x[0] != y[0]).sum()) for x, y in pairs),
                     sum(x[0].numel() for x, _ in pairs))
    first = None
    for i, ((ia, ma), (ib, mb)) in enumerate(zip(a, b)):
        rows = (ia != ib).any(-1)
        if bool(rows.any()):
            first = (i, int(rows.sum()),
                     float(torch.maximum(ma[rows], mb[rows]).max()),
                     float(ma.median()))
            break
    return out, first


def phase_full_model(arch, cfg, n_want, counters, plain, time_layer):
    """``arch`` on the card at ``cfg`` (its full config, or one cut in
    depth): the parameter count, a prefill and 8 decode steps through the
    kernels and through the plain versions (``plain``, passed by name;
    logits held together), then where a prefill's and a decode step's
    time goes (``time_layer(kind, lp, x, cfg, cache, spent, lengths) -> x``
    runs one block cut into segments) and how much of each the card is
    busy.  ``counters`` name the kernel wrappers whose launches each path
    prints.

    A mixture-of-experts model's two paths may route a token near a top-k
    tie to other experts (the attention paths differ in bf16): each
    path's expert ids are recorded at every layer of the prefill and the
    decode steps, and the ids that differ are counted.  The plain path
    then runs again with the kernel path's expert choices; its logits are
    held to the bar, and the free plain path's too where no id differs.
    -> the parameters."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm, moe
    n = lm.n_params(cfg)
    if n != n_want or cfg.dtype != "bfloat16":
        raise AssertionError(f"{arch}: {n} parameters in {cfg.dtype}")
    full = registry.get(arch)[0]
    depth = "" if full.n_layers == cfg.n_layers else (
        f"; cut to {cfg.n_layers} of {full.n_layers} layers, "
        f"{lm.n_params(full)} parameters at full depth")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    print(f"{arch}: {n} parameters ({cfg.param_dtype} at rest, {cfg.dtype} "
          f"compute{depth}), init {time.perf_counter() - t0:.3f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    b, s, nd = SERVE_BATCH, SERVE_CHUNK, 8
    toks = torch.randint(0, cfg.vocab, (b, s + nd), generator=gen,
                         device="cuda")
    model_steps(lm, params, cfg, toks, 1)                       # warm
    logits, times, routes = {}, {}, {}
    for path, kernels in (("kernel", {}), ("plain", plain)):
        n0 = {k: f.launches for k, f in counters.items()}
        with expert_choices(moe, record=routes.setdefault(path, [])):
            logits[path], t_pre, t_dec = model_steps(lm, params, cfg, toks,
                                                     nd, **kernels)
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
          f"{'ok' if ok else 'over the bar'}", flush=True)
    if cfg.n_experts:
        flips, first = routing_flips(routes["kernel"], routes["plain"],
                                     cfg.n_layers)
        n_flips = sum(d for d, _ in flips.values())
        print(f"model {arch} expert ids (token, layer, choice) that differ "
              f"between the kernel and the plain path: " + ", ".join(
                  f"{k} {d} of {t} ({d / t:.4%})"
                  for k, (d, t) in flips.items()), flush=True)
        if first is not None:
            call, rows, margin, median = first
            where = (f"prefill layer {call}" if call < cfg.n_layers else
                     f"decode step {call // cfg.n_layers} layer "
                     f"{call % cfg.n_layers}")
            print(f"model {arch}: the paths first route apart at {where}: "
                  f"{rows} tokens, each with a margin (the least gap "
                  f"between neighbours of its {cfg.top_k + 1} largest "
                  f"probabilities) of at most {margin:.3g} in either path "
                  f"(median margin there {median:.3g}); later layers take "
                  f"the moved tokens' changed residuals", flush=True)
        force = iter(routes["kernel"])
        with expert_choices(moe, force=force):
            forced, _, _ = model_steps(lm, params, cfg, toks, nd, **plain)
        if next(force, None) is not None:
            raise AssertionError(f"{arch}: the plain path routed fewer "
                                 f"times than the kernel path")
        ferr = float((a - forced).abs().max())
        ftol = MODEL_LOGITS_TOL * float(forced.abs().max())
        fok = bool(torch.isfinite(forced).all()) and ferr <= ftol
        print(f"model {arch} kernel path vs the plain path with its expert "
              f"choices: max abs diff {ferr:.4g} (mean "
              f"{float((a - forced).abs().mean()):.3g}), tolerance "
              f"{ftol:.4g}: {'ok' if fok else 'FAILED'}", flush=True)
        if not ok and n_flips:
            print(f"model {arch}: the free plain path is over the bar, and "
                  f"{n_flips} expert ids differ between the paths; with "
                  f"the kernel path's choices it is "
                  f"{'within' if fok else 'over'} the bar", flush=True)
        ok = fok and (ok or n_flips > 0)
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
        print(f"{arch} one {name}: {wall:.2f} ms wall, "
              f"{card_text(busy, '.2f')} ms of kernels and copies on the "
              f"card (torch.profiler, mean of {k}), device idle share "
              f"{card_text(idle, '.1%')}", flush=True)
    print(f"{arch} model phase: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return params


def phase_attn_model(fa, da, arch, cfg, n_want):
    """``arch``, a model of attention blocks, at ``cfg`` on the card
    (:func:`phase_full_model`), each block cut into casts, projections,
    attention and FFN (a mixture of experts: routing, expert products and
    combine).  -> the parameters, for the serve phase."""
    from repro_torch.models import layers

    def time_layer(kind, lp, x, cfg, cache, spent, lengths):
        return timed_attn_layer(layers, lp, x, cfg, cache, spent,
                                lengths=lengths)[0]
    return phase_full_model(
        arch, cfg, n_want, {"flash_attention": fa.flash_attention,
                            "decode_attention": da.decode_attention},
        dict(flash_attention=fa.flash_attention_ref,
             decode_attention=da.decode_attention_ref), time_layer)


def phase_yi_model(fa, da):
    """yi-6b at its full config on the card (:func:`phase_attn_model`).
    -> the parameters, for the serve phase."""
    from repro_torch.configs import registry
    return phase_attn_model(fa, da, YI, registry.get(YI)[0], YI_PARAMS)


def phase_serve_once(arch, cfg, counters, params, *, with_decode) -> tuple:
    """``arch``'s serving path: calibrate once on the card, then asl, fifo
    and greedy answer one Poisson stream on that cost model for
    SERVE_DURATION_S, with a TTFT SLO of 4 x the mean prompt's prefill.
    The rate puts half of the slot on the mean request: its prompt's
    prefill chunks, and (``with_decode``) its mean new tokens decoded at
    batch 1.  The kernel counters are set to 0 just before and read just
    after.  ``cfg`` is ``arch``'s config (full, or cut in depth).  ->
    (launches, rate, SLO)."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    for f in counters.values():
        f.launches = 0
        for extra in ("launches_tc", "launches_split", "launches_decode"):
            if hasattr(f, extra):
                setattr(f, extra, 0)
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
    launches.update({f"{k} split": f.launches_split
                     for k, f in counters.items()
                     if hasattr(f, "launches_split")})
    launches.update({f"{k} decode": f.launches_decode
                     for k, f in counters.items()
                     if hasattr(f, "launches_decode")})
    # Every attention call of a serving run is bf16: the tensor-core route.
    routes = {k: f.launches_tc for k, f in counters.items()
              if hasattr(f, "launches_tc")}
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
    split = {k: f.launches_split for k, f in counters.items()
             if hasattr(f, "launches_split")}
    print(f"serve {arch}: tensor-core route launches {routes} of "
          f"{ {k: launches[k] for k in routes} }; decode calls split over "
          f"the cache {split} of { {k: launches[k] for k in split} }",
          flush=True)
    # Every decode shape of a calibration (batch 8, one or four kv heads)
    # has fewer rows than the card has SMs: the wrapper splits it.
    if any(n <= 0 for n in split.values()):
        raise AssertionError(f"the {arch} serving path never split a "
                             f"decode call: {split}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"the {arch} serving path launched a kernel "
                             f"no time: {launches}")
    if any(n != launches[k] for k, n in routes.items()):
        raise AssertionError(f"the {arch} serving path left the "
                             f"tensor-core route: {routes} of {launches}")
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
    """(max abs error, within RGLRU_TOL: bit for bit)."""
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


# Sequence lengths that cross the scan's 64-step ring chunks, and widths
# whose rows start on 16 bytes (2560) or not (100 in bf16, 17).
RGLRU_SEQS = (1, 7, 63, 64, 65, 3 * 64 + 5)
RGLRU_WIDTHS = (2560, 100, 17)


def rglru_timing(rs, gen, name, b, s, r, h0) -> dict:
    """The forward at one main-path shape (f32, as the model calls it):
    ms a launch back to back and on the card, against the plain version
    and the bound; bit for bit."""
    import torch
    a, x, c = rglru_inputs(gen, b, s, r, torch.float32, h0)
    kernel_ms, times = median_ms(lambda: rs.rglru_scan(a, x, c), reps=50)
    _, card_ms, _ = device_busy(lambda: rs.rglru_scan(a, x, c), 50)
    got = rs.rglru_scan(a, x, c)
    out = {}
    plain_ms = cuda_ms(lambda: out.update(want=rs.rglru_scan_ref(a, x, c)))
    err, ok = rglru_check(got, out["want"], torch.float32)
    bnd, by = rglru_bound(b, s, r, 4, h0)
    print(f"rglru_scan {name} B={b} S={s} R={r} f32: kernel "
          f"{kernel_ms:.4f} ms/launch (of {[round(t, 4) for t in times]}; "
          f"on the card {card_text(card_ms)}), plain {plain_ms:.2f} ms, "
          f"bound "
          f"{bnd:.5f} ms ({by}), max abs err {err:.3g}", flush=True)
    if not ok:
        raise AssertionError(f"rglru_scan != plain at the {name} shape")
    return {"ms": kernel_ms, "card_ms": card_ms, "plain_ms": plain_ms,
            "max_abs_err": err, "bound_ms": bnd, "bound_by": by}


def phase_rglru(rs, build) -> dict:
    """rglru_scan == its plain version on the card over the listed cases
    (bit for bit: h, and so the last carry h[:, -1]; two calls
    bit-equal), the launch plans and ptxas's spills; then the serving
    prefill, decode and training shapes timed against their bounds, and
    16 against 32 channels a block where the plan picks between them."""
    import torch
    spilled = spills(build, "rglru_scan")
    print(f"rglru_scan spill bytes (ptxas): {spilled}", flush=True)
    if not spilled or any(spilled.values()):
        raise AssertionError("rglru_scan spills registers")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    n_bad = n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for s in RGLRU_SEQS + (SERVE_CHUNK,):
            for r in RGLRU_WIDTHS:
                for h0 in (False, True):
                    a, x, h = rglru_inputs(gen, 2, s, r, dtype, h0)
                    n0 = rs.rglru_scan.launches
                    got = rs.rglru_scan(a, x, h)
                    again = rs.rglru_scan(a, x, h)
                    torch.cuda.synchronize()
                    err, ok = rglru_check(got, rs.rglru_scan_ref(a, x, h),
                                          dtype)
                    ok = ok and bit_equal(got, again) \
                        and rs.rglru_scan.launches == n0 + 2
                    n_cases += 1
                    n_bad += not ok
                    print(f"rglru_scan {dtype} B=2 S={s} R={r} h0={h0}: "
                          f"max abs err {err:.3g} "
                          f"{'ok' if ok else 'OVER TOLERANCE'}", flush=True)
    print(f"rglru_scan sweep: {n_cases - n_bad}/{n_cases} cases bit for bit "
          f"(f32 and bf16; two calls bit-equal)", flush=True)
    if n_bad:
        raise AssertionError(f"rglru_scan != plain in {n_bad} cases")
    r = 2560
    shapes = {"serving prefill": (SERVE_BATCH, SERVE_CHUNK, False),
              "decode": (SERVE_BATCH, 1, True),
              "training forward": (1, TRAIN_SEQ, False)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (b, s, _) in shapes.items():
        print(f"rglru_scan launch plan, {name} (B={b} S={s} R={r} f32, "
              f"{sms} SMs): {rs.launch_plan(b, s, r, 4, sms)}", flush=True)
    print(f"rglru_scan_bwd launch plan, training (B=1 S={TRAIN_SEQ} R={r} "
          f"f32): {rs.launch_plan(1, TRAIN_SEQ, r, 4, sms, backward=True)}",
          flush=True)
    out = {name: rglru_timing(rs, gen, name, b, s, r, h0)
           for name, (b, s, h0) in shapes.items()}
    # The plan's choice of channels a block, against the other one.
    for name in ("serving prefill", "training forward"):
        b, s, _ = shapes[name]
        a, x, _ = rglru_inputs(gen, b, s, r, torch.float32, False)
        ch = {c: median_ms(lambda: rs.rglru_scan(a, x, channels=c),
                           reps=50)[0] for c in rs.CHANNELS}
        out[name]["by_channels"] = ch
        print(f"rglru_scan {name}: ms a launch by channels a block "
              f"{ {c: round(t, 5) for c, t in ch.items()} } (the plan: "
              f"{rs.launch_plan(b, s, r, 4, sms).channels})", flush=True)
    return out


def phase_rg_model(rs, fa, da):
    """recurrentgemma-2b at its full config on the card
    (:func:`phase_full_model`), each RG-LRU block cut into casts, RG-LRU
    projections, conv and gates, ``rglru_scan`` and FFN, and each local
    attention block into casts, projections, attention and FFN.  -> the
    parameters, for the serve phase."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import layers, rglru

    def time_layer(kind, lp, x, cfg, cache, spent, lengths):
        if kind == "rglru":
            return timed_rglru_layer(rglru, layers, ops, lp, x, cfg, cache,
                                     spent, decode=lengths is not None)
        return timed_attn_layer(layers, lp, x, cfg, cache, spent,
                                lengths=lengths, local=True)[0]
    return phase_full_model(
        RG, registry.get(RG)[0], RG_PARAMS,
        {"rglru_scan": rs.rglru_scan, "flash_attention": fa.flash_attention,
         "decode_attention": da.decode_attention},
        dict(rglru_scan=rs.rglru_scan_ref,
             flash_attention=fa.flash_attention_ref,
             decode_attention=da.decode_attention_ref), time_layer)


# ---------------------------------------------------------------------------
# gemma-7b: the attention kernels at its shapes, the model and its server
# ---------------------------------------------------------------------------

def phase_attention_shapes(fa, da, arch, h, kh, dh, seed) -> dict:
    """``flash_attention`` and ``decode_attention`` at ``arch``'s serving
    shapes (``h`` q heads on ``kh`` kv heads of ``dh``, bf16): a causal
    unwindowed prefill of SERVE_CHUNK tokens (and its ragged edges), and a
    decode over the full 2 x SERVE_CHUNK-slot cache at lengths from 1 to
    every slot, split and unsplit, each against its plain version; then
    both timed at the serving path's shapes beside their bounds, the plain
    versions and PyTorch's fused attention.  -> {kernel: timing}."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    b, s, t = SERVE_BATCH, SERVE_CHUNK, 2 * SERVE_CHUNK
    heads = f"H={h} K={kh} (group {h // kh})"
    bad = []
    for sq, tk in ((s, s), (1, s), (s - 1, s), (s + 1, s + 1), (64, t)):
        err, ok = flash_case(fa, gen, b, h, kh, sq, tk, dh, torch.bfloat16,
                             True, 0)
        print(f"flash_attention {arch} B={b} {heads} dh={dh} S={sq} "
              f"T={tk} causal bf16: max abs err {err:.3g}"
              f"{'' if ok else ' OVER TOLERANCE'}", flush=True)
        bad += [] if ok else [("flash", sq, tk)]
    for lengths in ([1] * b, [s + 1] * b, [t - 1] * b, [t] * b,
                    [0, 1, 17, 255, 256, 257, 511, 512]):
        err, ok = decode_case(da, gen, b, h, kh, t, dh, torch.bfloat16,
                              lengths)
        print(f"decode_attention {arch} B={b} {heads} T={t} dh={dh} "
              f"lengths {sorted(set(lengths))} bf16, split and unsplit: "
              f"max abs err {err:.3g}{'' if ok else ' OVER TOLERANCE'}",
              flush=True)
        bad += [] if ok else [("decode", lengths)]
    if bad:
        raise AssertionError(f"{arch} attention shapes != plain: {bad}")
    return {"flash_attention": flash_timing(
                fa, gen, f"{arch} serve", b, h, kh, s, dh, 0),
            "decode_attention": decode_timing(
                da, gen, b, h, kh, t, dh, s + 1, None)}


def phase_gemma_kernels(fa, da) -> dict:
    """Both attention kernels at gemma-7b's serving shapes (16 q heads on
    16 kv heads of 256: group 1; :func:`phase_attention_shapes`)."""
    return phase_attention_shapes(fa, da, GEMMA, 16, 16, 256, 4)


def phase_gemma_model(fa, da):
    """gemma-7b at its full config on the card (:func:`phase_attn_model`:
    34.2 GB of f32 weights).  -> the parameters, for the serve phase."""
    from repro_torch.configs import registry
    return phase_attn_model(fa, da, GEMMA, registry.get(GEMMA)[0],
                            GEMMA_PARAMS)


# ---------------------------------------------------------------------------
# phi3.5-moe, grok-1, llama3-405b and qwen1.5-110b at every width, cut in
# depth: the attention kernels at their shapes, the models and their
# servers
# ---------------------------------------------------------------------------

def phase_cut_models(fa, da, laps) -> dict:
    """Each of ``CUT_MODELS`` in turn: its full config's depth and
    parameters checked, both attention kernels at its shapes
    (:func:`phase_attention_shapes`), the model cut in depth on the card
    (:func:`phase_attn_model`), then served (:func:`phase_serve_once`);
    its weights freed before the next.  -> {arch: (kernel timings, serve
    launches, GQA group)}."""
    import dataclasses

    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm
    counters = {"flash_attention": fa.flash_attention,
                "decode_attention": da.decode_attention}
    out = {}
    for seed, (arch, (cut, n_cut, depth, n_full)) in enumerate(
            CUT_MODELS.items(), start=5):
        full = registry.get(arch)[0]
        if (full.n_layers, lm.n_params(full)) != (depth, n_full):
            raise AssertionError(f"{arch}: {full.n_layers} layers, "
                                 f"{lm.n_params(full)} parameters")
        cfg = dataclasses.replace(full, n_layers=cut)
        h, kh = cfg.n_heads, cfg.n_kv_heads
        shapes = phase_attention_shapes(fa, da, arch, h, kh, cfg.head_dim,
                                        seed)
        params = phase_attn_model(fa, da, arch, cfg, n_cut)
        launches, _, _ = phase_serve_once(arch, cfg, counters, params,
                                          with_decode=True)
        del params
        torch.cuda.empty_cache()
        out[arch] = (shapes, launches, h // kh)
        laps.lap(f"13e-13h {arch}")
    return out


# ---------------------------------------------------------------------------
# llava-next-mistral-7b and hubert-xlarge: the two frontends at full config
# and flash_attention at head dim 80
# ---------------------------------------------------------------------------

def phase_llava_kernels(fa, da) -> dict:
    """``flash_attention`` and ``decode_attention`` at llava's shapes (32
    q heads on 8 kv heads of 128, bf16): its causal prefill of 3,008
    positions (and the ragged edges around it), and a decode over the
    4,096-slot cache at lengths up to 3,016, split and unsplit, each
    against its plain version; then both timed at those shapes beside
    their bounds, the plain versions and PyTorch's fused attention.
    -> {kernel: timing}."""
    import torch
    from repro_torch.configs import registry
    cfg = registry.get(LLAVA)[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    b, h, kh, dh = SERVE_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s, t = cfg.n_patches + LLAVA_TEXT, LLAVA_CACHE
    last = s + FRONTEND_DECODE
    bad = []
    for sq, tk in ((s, s), (1, s), (s - 1, s), (s + 1, s + 1), (64, t)):
        err, ok = flash_case(fa, gen, b, h, kh, sq, tk, dh, torch.bfloat16,
                             True, 0)
        print(f"flash_attention {LLAVA} B={b} H={h} K={kh} dh={dh} S={sq} "
              f"T={tk} causal bf16: max abs err {err:.3g}"
              f"{'' if ok else ' OVER TOLERANCE'}", flush=True)
        bad += [] if ok else [("flash", sq, tk)]
    for lengths in ([1] * b, [s] * b, [s + 1] * b, [last] * b,
                    [0, 1, 17, cfg.n_patches, s, s + 1, s + 4, last]):
        err, ok = decode_case(da, gen, b, h, kh, t, dh, torch.bfloat16,
                              lengths)
        print(f"decode_attention {LLAVA} B={b} H={h} K={kh} T={t} dh={dh} "
              f"lengths {sorted(set(lengths))} bf16, split and unsplit: "
              f"max abs err {err:.3g}{'' if ok else ' OVER TOLERANCE'}",
              flush=True)
        bad += [] if ok else [("decode", lengths)]
    if bad:
        raise AssertionError(f"{LLAVA} attention shapes != plain: {bad}")
    return {"flash_attention": flash_timing(
                fa, gen, f"{LLAVA} prefill", b, h, kh, s, dh, 0),
            "decode_attention": decode_timing(
                da, gen, b, h, kh, t, dh, s + 1, None)}


def dh80_timing(fa, gen, b, h, kh, s, t, dh, dtype) -> dict:
    """One bidirectional shape in the model's layout (transposed views):
    the kernel timed against its bound (bf16 on the tensor cores, f32 on
    the f32 pipes), the plain version and PyTorch's fused attention, and
    held to the plain version."""
    import torch
    f = lambda *shape: torch.randn(*shape, generator=gen, device="cuda") \
        .to(dtype)
    q, k, v = (x.transpose(1, 2) for x in (f(b, s, h, dh), f(b, t, kh, dh),
                                            f(b, t, kh, dh)))
    kernel_ms, times = median_ms(
        lambda: fa.flash_attention(q, k, v, causal=False))
    _, dev_ms, _ = device_busy(
        lambda: fa.flash_attention(q, k, v, causal=False), 10)
    got = fa.flash_attention(q, k, v, causal=False)
    out = {}
    plain_ms = cuda_ms(lambda: out.update(want=fa.flash_attention_ref(
        q, k, v, causal=False)))
    err = float((got.float() - out["want"].float()).abs().max())
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    lib_ms, _ = median_ms(lambda: library_attention(qc, kc, vc, False))
    esize = q.element_size()
    n_bytes = esize * (2 * q.numel() + k.numel() + v.numel())
    flops = 2 * 2 * b * h * s * t * dh
    bnd, by = bound(n_bytes, flops, BF16_OPS_PER_S if dtype ==
                    torch.bfloat16 else F32_OPS_PER_S)
    name = str(dtype).replace("torch.", "")
    print(f"flash_attention {HUBERT} dh={dh} B={b} H={h} K={kh} S={s} T={t} "
          f"{name} bidirectional: kernel {kernel_ms:.4f} ms/launch (of "
          f"{[round(x, 4) for x in times]}; on the card "
          f"{card_text(dev_ms)}), plain {plain_ms:.3f} ms, library "
          f"{lib_ms:.4f} ms, bound {bnd:.5f} ms ({by}; "
          f"{n_bytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP), max abs err "
          f"{err:.3g}", flush=True)
    if err > attn_tol(dtype):
        raise AssertionError(f"flash_attention != plain at dh={dh} B={b} "
                             f"S={s} T={t} {name}")
    return {"ms": kernel_ms, "card_ms": dev_ms, "plain_ms": plain_ms,
            "max_abs_err": err, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_ms}


def phase_hubert_kernels(fa, fb, da) -> dict:
    """``flash_attention`` at hubert's head dim of 80 (16 q heads on 16 kv
    heads, bidirectional) on both routes: each of ``DH80_LENGTHS`` against
    its plain version (``flash_case``: every bf16 launch on the tensor-core
    route, every f32 one not), then timed (``dh80_timing``).  A dh-80
    ``flash_attention_bwd`` or ``decode_attention`` call on the card must
    raise, launching nothing.  -> {"<dtype> S/T": timing}."""
    import torch
    from repro_torch.configs import registry
    cfg = registry.get(HUBERT)[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out, bad = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        for s, t in DH80_LENGTHS:
            b = SERVE_BATCH if s == HUBERT_FRAMES else 2
            err, ok = flash_case(fa, gen, b, h, kh, s, t, dh, dtype, False,
                                 0)
            name = f"{str(dtype).replace('torch.', '')} {s}/{t}"
            print(f"flash_attention {HUBERT} dh={dh} B={b} S={s} T={t} "
                  f"{name.split()[0]} bidirectional: max abs err {err:.3g}"
                  f"{'' if ok else ' OVER TOLERANCE'}", flush=True)
            if not ok:
                bad.append(name)
                continue
            out[name] = dict(dh80_timing(fa, gen, b, h, kh, s, t, dh,
                                         dtype), batch=b)
    if bad:
        raise AssertionError(f"flash_attention at dh {dh} != plain: {bad}")
    x = torch.zeros((1, h, 8, dh), dtype=torch.bfloat16, device="cuda")
    lse = torch.zeros((1, h, 8), device="cuda")
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    n0 = (fb.flash_attention_bwd.launches, da.decode_attention.launches)
    for name, call in (
            ("flash_attention_bwd", lambda: fb.flash_attention_bwd(
                x, x, x, x, lse, x, causal=False)),
            ("decode_attention", lambda: da.decode_attention(
                x[:, :, 0], x, x, lens))):
        try:
            call()
        except ValueError as e:
            if "head dims" not in str(e):
                raise
            print(f"{name} at dh {dh} on the card raises: {e}", flush=True)
        else:
            raise AssertionError(f"{name} took head dim {dh}")
    if (fb.flash_attention_bwd.launches, da.decode_attention.launches) != n0:
        raise AssertionError("a dh-80 call launched a kernel")
    return out


def frontend_batch(cfg, gen, b) -> tuple:
    """A batch of a frontend model's phase, from ``gen`` (f32 normals for
    the stubs' precomputed embeddings): hubert's ``frames`` [B, 1,000,
    d_model]; llava's ``n_patches`` ``patch_embeds`` and LLAVA_TEXT
    tokens.  -> (batch, the decode steps' tokens or None)."""
    import torch
    if cfg.frontend == "audio_stub":
        return {"frames": torch.randn(b, HUBERT_FRAMES, cfg.d_model,
                                      generator=gen, device="cuda")}, None
    toks = torch.randint(0, cfg.vocab, (b, LLAVA_TEXT + FRONTEND_DECODE),
                         generator=gen, device="cuda")
    return {"patch_embeds": torch.randn(b, cfg.n_patches, cfg.d_model,
                                        generator=gen, device="cuda"),
            "tokens": toks[:, :LLAVA_TEXT]}, toks[:, LLAVA_TEXT:]


def frontend_steps(lm, params, cfg, batch, dec_toks, **kernels) -> tuple:
    """hubert: one ``lm.forward``; llava: ``lm.prefill`` into a
    LLAVA_CACHE-slot cache, then a decode step for each of ``dec_toks``'
    columns.  -> (logits [B, S or 1 + steps, V], the forward's or
    prefill's seconds, the mean decode step's seconds or None)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if dec_toks is None:
        out = lm.forward(params, cfg, batch, **kernels)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, None
    b = dec_toks.shape[0]
    out, cache = lm.prefill(params, cfg, batch,
                            lm.init_cache(cfg, b, LLAVA_CACHE, "cuda"),
                            **kernels)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    steps = [out]
    lengths = torch.full((b,), cfg.n_patches + LLAVA_TEXT, dtype=torch.int32,
                         device="cuda")
    t0 = time.perf_counter()
    for i in range(dec_toks.shape[1]):
        out, cache, lengths = lm.decode_step(
            params, cfg, dec_toks[:, i:i + 1], lengths, cache, **kernels)
        steps.append(out)
    torch.cuda.synchronize()
    return torch.cat(steps, dim=1), t_pre, \
        (time.perf_counter() - t0) / dec_toks.shape[1]


def phase_frontend_model(fa, da, arch, n_want) -> dict:
    """``arch`` (llava or hubert) at its full config on the card: the
    parameter count, its steps (``frontend_steps``) through the kernels and
    through the plain versions with the kernel counters read around the
    kernel path, logits held together (3 % of the largest); every
    ``flash_attention`` launch on the tensor-core route and, for llava,
    every ``decode_attention`` call split.  Then where a forward's,
    prefill's and decode step's time goes (``timed_attn_layer``: casts,
    projections, attention, FFN; and the unembedding), how much of each
    the card is busy, and the peak memory.  The weights are freed.
    -> {"launches": {counter: n}, "times": {step: ms}}."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import layers, lm
    cfg = registry.get(arch)[0]
    n = lm.n_params(cfg)
    if n != n_want or cfg.dtype != "bfloat16":
        raise AssertionError(f"{arch}: {n} parameters in {cfg.dtype}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    print(f"{arch}: {n} parameters ({cfg.param_dtype} at rest, {cfg.dtype} "
          f"compute, frontend {cfg.frontend}), init "
          f"{time.perf_counter() - t0:.3f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    b = SERVE_BATCH
    batch, dec_toks = frontend_batch(cfg, gen, b)
    s = HUBERT_FRAMES if dec_toks is None else cfg.n_patches + LLAVA_TEXT
    what = (f"forward of {b} x {s} frames" if dec_toks is None else
            f"prefill of {b} x ({cfg.n_patches} patches + {LLAVA_TEXT} "
            f"tokens), {FRONTEND_DECODE} decode steps")
    counters = {"flash_attention": (fa.flash_attention, "launches"),
                "flash_attention tensor-core": (fa.flash_attention,
                                                "launches_tc"),
                "decode_attention": (da.decode_attention, "launches"),
                "decode_attention split": (da.decode_attention,
                                           "launches_split")}
    count = lambda: {k: getattr(f, a) for k, (f, a) in counters.items()}
    frontend_steps(lm, params, cfg, batch, dec_toks)            # warm
    logits, times, launches = {}, {}, {}
    for path, kernels in (("kernel", {}), ("plain", dict(
            flash_attention=fa.flash_attention_ref,
            decode_attention=da.decode_attention_ref))):
        n0 = count()
        logits[path], t_pre, t_dec = frontend_steps(
            lm, params, cfg, batch, dec_toks, **kernels)
        launches[path] = {k: v - n0[k] for k, v in count().items()}
        times[path] = (t_pre, t_dec)
        print(f"model {arch} {path} path: {what}: "
              f"{'forward' if t_dec is None else 'prefill'} "
              f"{t_pre * 1e3:.2f} ms"
              + ("" if t_dec is None else
                 f", decode step {t_dec * 1e3:.2f} ms (mean of "
                 f"{FRONTEND_DECODE})")
              + f"; launches {launches[path]}", flush=True)
    k_run = launches["kernel"]
    layers_n, steps = cfg.n_layers, 0 if dec_toks is None else \
        dec_toks.shape[1]
    want = {"flash_attention": layers_n,
            "flash_attention tensor-core": layers_n,
            "decode_attention": layers_n * steps,
            "decode_attention split": layers_n * steps}
    if k_run != want or any(launches["plain"].values()):
        raise AssertionError(f"{arch} launches {launches}, the kernel path "
                             f"should launch {want} and the plain none")
    a, w = logits["kernel"], logits["plain"]
    err = float((a - w).abs().max())
    tol = MODEL_LOGITS_TOL * float(w.abs().max())
    shape = (b, s if dec_toks is None else 1 + steps, cfg.vocab)
    ok = bool(torch.isfinite(a).all()) and tuple(a.shape) == shape \
        and err <= tol
    print(f"model {arch} kernel vs plain logits {tuple(a.shape)}: max abs "
          f"diff {err:.4g} (mean {float((a - w).abs().mean()):.3g}, largest "
          f"logit {float(w.abs().max()):.4g}), tolerance {tol:.4g} "
          f"({MODEL_LOGITS_TOL:.0%} of the largest): "
          f"{'ok' if ok else 'over the bar'}", flush=True)
    if not ok:
        raise AssertionError(f"{arch} logits: kernel path != plain path")
    del logits, a, w
    # Where a step's time goes.
    p = params.tree()
    names = ("forward",) if dec_toks is None else ("prefill", "decode")
    for name in names:
        spent = {}
        decode = name == "decode"
        x = lm._embed_tokens(p, cfg, dec_toks[:, :1]) if decode else \
            lm._inputs_to_x(p, cfg, batch)
        cache = None if dec_toks is None else lm._layer_caches(
            lm.init_cache(cfg, b, LLAVA_CACHE, "cuda"), cfg)
        lengths = torch.full((b,), s, dtype=torch.int32, device="cuda") \
            if decode else None
        for i, (_, lp) in enumerate(lm._layers(p, cfg)):
            x, _ = timed_attn_layer(layers, lp, x, cfg,
                                    None if cache is None else cache[i],
                                    spent, lengths=lengths)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm._unembed(p, cfg, x if name == "forward" else x[:, -1:])
        torch.cuda.synchronize()
        spent["unembed"] = time.perf_counter() - t0
        tot = sum(spent.values())
        print(f"{arch} one {name}, {cfg.n_layers} blocks cut by "
              f"synchronisations ({tot * 1e3:.2f} ms in all; uncut "
              f"{times['kernel'][decode] * 1e3:.2f} ms): "
              + ", ".join(f"{k} {v * 1e3:.2f} ms ({v / tot:.1%})"
                          for k, v in spent.items()), flush=True)
        del x, cache
    # How much of a step the card is busy.
    if dec_toks is None:
        busy = [("forward", lambda: lm.forward(params, cfg, batch), 3)]
    else:
        _, cache = lm.prefill(params, cfg, batch, lm.init_cache(
            cfg, b, LLAVA_CACHE, "cuda"))
        lengths = torch.full((b,), s, dtype=torch.int32, device="cuda")
        busy = [("prefill", lambda: lm.prefill(
                    params, cfg, batch,
                    lm.init_cache(cfg, b, LLAVA_CACHE, "cuda")), 2),
                ("decode step", lambda: lm.decode_step(
                    params, cfg, dec_toks[:, :1], lengths, cache), 3)]
    idle = {}
    for name, fn, k in busy:
        wall, card, idle[name] = device_busy(fn, k)
        print(f"{arch} one {name}: {wall:.2f} ms wall, "
              f"{card_text(card, '.2f')} ms of kernels and copies on the "
              f"card (torch.profiler, mean of {k}), device idle share "
              f"{card_text(idle[name], '.1%')}", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{arch} model phase: max_memory_allocated {peak:.2f} GiB",
          flush=True)
    del params, busy
    torch.cuda.empty_cache()
    return {"launches": k_run, "peak_gib": peak, "idle": idle,
            "times_ms": {k: None if v is None else v * 1e3 for k, v in zip(
                ("first", "decode"), times["kernel"])}}


def phase_llava(fa, da) -> dict:
    """13i: both attention kernels at llava's shapes, then the model."""
    kernels = phase_llava_kernels(fa, da)
    return dict(phase_frontend_model(fa, da, LLAVA, LLAVA_PARAMS),
                kernels=kernels)


def phase_hubert(fa, fb, da) -> dict:
    """13j: flash_attention at head dim 80, then the encoder."""
    shapes = phase_hubert_kernels(fa, fb, da)
    return dict(phase_frontend_model(fa, da, HUBERT, HUBERT_PARAMS),
                shapes=shapes)


# ---------------------------------------------------------------------------
# Training: flash_attention's LSE rows, flash_attention_bwd, the scan's
# backward, one full-width step, recurrentgemma-2b trained at full config
# and its checkpoint
# ---------------------------------------------------------------------------

def bwd_tol(dtype) -> float:
    return FLASH_BWD_TOL[str(dtype).replace("torch.", "")]


def visible_pairs(s, t, causal, window) -> int:
    """(i, j) pairs the attention mask lets through, this run's shape."""
    if not causal:
        return s * t
    return sum(max(0, min(i, t - 1) - (max(0, i - window + 1) if window
                                       else 0) + 1) for i in range(s))


def flash_bwd_bound(b, h, kh, s, t, dh, esize, causal, window) -> tuple:
    """Least time of one backward call: q, out, do, dq and k, v, dk, dv
    once in their type, lse and delta once in f32; 5 products of 2 dh
    operations over every visible pair on the bf16 tensor cores."""
    n_bytes = 4 * b * h * s * dh * esize + 4 * b * kh * t * dh * esize \
        + 2 * b * h * s * 4
    flops = 5 * 2 * dh * b * h * visible_pairs(s, t, causal, window)
    return bound(n_bytes, flops) + (n_bytes, flops)


def lse_close(lse, want) -> bool:
    """The log-sum-exp rows against the plain version's: within 1e-4
    where a key is visible, +inf where none is."""
    import torch
    fin = torch.isfinite(want)
    return bool(torch.equal(torch.isfinite(lse), fin)) and bool(
        (lse[~fin] > 0).all()) and bool(torch.allclose(
            lse[fin], want[fin], atol=1e-4, rtol=1e-5))


def rel_err(a, w) -> float:
    """||a - w|| / ||w|| over the whole tensor, in f32."""
    import torch
    a, w = a.float(), w.float()
    return float(torch.linalg.vector_norm(a - w)
                 / torch.linalg.vector_norm(w))


def grads_close(got, want, tol) -> bool:
    """(dq, dk, dv) against the plain version's, element by element."""
    import torch
    return all(a.dtype == w.dtype and a.shape == w.shape
               and bool(torch.isfinite(a).all())
               and torch.allclose(a.float(), w.float(), atol=tol, rtol=tol)
               for a, w in zip(got, want))


def flash_bwd_case(fa, fb, gen, b, h, kh, s, t, dh, dtype, causal,
                   window) -> tuple:
    """The forward with its LSE rows and the backward against their plain
    versions on one case; -> (lse ok, out unchanged, max abs err of dq,
    dk, dv, bwd ok)."""
    import torch
    f = lambda *shape: torch.randn(*shape, generator=gen, device="cuda") \
        .to(dtype)
    q, k, v, do = f(b, h, s, dh), f(b, kh, t, dh), f(b, kh, t, dh), \
        f(b, h, s, dh)
    n0, m0 = fa.flash_attention.launches, fb.flash_attention_bwd.launches
    tc0 = fa.flash_attention.launches_tc, fb.flash_attention_bwd.launches_tc
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    plain_out = fa.flash_attention(q, k, v, causal=causal, window=window)
    got = fb.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    lse_ok = lse_close(lse, fa.flash_attention_lse_ref(
        q, k, causal=causal, window=window))
    same = bool(torch.equal(out, plain_out))
    want = fb.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                      window=window)
    tol = bwd_tol(dtype)
    err = max(float((a.float() - w.float()).abs().max()) for a, w in
              zip(got, want))
    tc = int(dtype == torch.bfloat16)
    ok = grads_close(got, want, tol) \
        and fa.flash_attention.launches == n0 + 2 \
        and fb.flash_attention_bwd.launches == m0 + 1 \
        and (fa.flash_attention.launches_tc,
             fb.flash_attention_bwd.launches_tc) == (tc0[0] + 2 * tc,
                                                     tc0[1] + tc)
    return lse_ok, same, err, ok


def library_attention_bwd(q, k, v, do, causal, window):
    """-> fn: the backward alone of PyTorch's fused attention on the same
    inputs (contiguous copies), with an explicit boolean mask for a
    window: the yardstick timed beside the kernel (``library_ms``); the
    port never calls it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import attention_mask
    qs, ks, vs = (x.detach().contiguous().requires_grad_() for x in (q, k, v))
    if causal and window:
        mask = attention_mask(q.shape[2], k.shape[2], True, window, "cuda")
        out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                             enable_gqa=True)
    else:
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                             enable_gqa=True)
    dos = do.contiguous()
    return lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                       retain_graph=True)


def forward_with_lse_timing(fa, q, k, v, window) -> dict:
    """The training forward (with its LSE rows) at one causal shape,
    timed against its bound (q, out, k, v once in their type, lse in f32;
    2 products of 2 dh operations over every visible pair), the plain
    version and PyTorch's fused attention."""
    import torch.nn.functional as F
    from repro_torch.kernels.ref import attention_mask
    b, h, s, dh = q.shape
    kh = k.shape[1]
    fwd = lambda: fa.flash_attention(q, k, v, causal=True, window=window,
                                     return_lse=True)
    ms, _ = median_ms(fwd, reps=3)
    _, card_ms, _ = device_busy(fwd, 3)
    plain = lambda: (fa.flash_attention_ref(q, k, v, causal=True,
                                            window=window),
                     fa.flash_attention_lse_ref(q, k, causal=True,
                                                window=window))
    plain()                                              # warm: allocations
    plain_ms = cuda_ms(plain)
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    mask = attention_mask(s, s, True, window, "cuda") if window else None
    lib_ms, _ = median_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, attn_mask=mask, is_causal=mask is None, enable_gqa=True),
        reps=3)
    esize = q.element_size()
    n_bytes = 2 * b * h * s * dh * esize + 2 * b * kh * s * dh * esize \
        + b * h * s * 4
    flops = 2 * 2 * dh * b * h * visible_pairs(s, s, True, window)
    bnd, by = bound(n_bytes, flops)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bnd, "bound_by": by, "card_ms": card_ms}


def flash_bwd_timing(fa, fb, gen, name, b, h, kh, s, dh, window) -> dict:
    """One causal training shape in bf16, in the model's layout
    (transposed views): the forward's output and LSE rows and the
    backward's dq, dk and dv against the plain versions element by
    element (ATTN_TOL, 1e-4, FLASH_BWD_TOL) and, for out, dq, dk and dv,
    by relative error (TRAIN_REL_TOL, which planted faults must exceed),
    then the backward timed against its bound, the plain version and
    PyTorch's fused attention's backward, and with its dk/dv split
    against none."""
    import torch
    f = lambda *shape: torch.randn(*shape, generator=gen, device="cuda") \
        .to(torch.bfloat16)
    q, k, v, do = (x.transpose(1, 2) for x in (
        f(b, s, h, dh), f(b, s, kh, dh), f(b, s, kh, dh), f(b, s, h, dh)))
    out, lse = fa.flash_attention(q, k, v, causal=True, window=window,
                                  return_lse=True)
    torch.cuda.synchronize()
    want_out = fa.flash_attention_ref(q, k, v, causal=True, window=window)
    tol = attn_tol(torch.bfloat16)
    out_err = float((out.float() - want_out.float()).abs().max())
    out_ok = out.dtype == want_out.dtype and bool(torch.allclose(
        out.float(), want_out.float(), atol=tol, rtol=tol))
    rel = {"out": rel_err(out, want_out)}
    planted = {f"out x {c}": (rel_err(out * c, want_out), bool(
        torch.allclose((out * c).float(), want_out.float(), atol=tol,
                       rtol=tol))) for c in PLANTED_SCALES}
    del want_out
    lse_ok = lse_close(lse, fa.flash_attention_lse_ref(q, k, causal=True,
                                                       window=window))
    fwd = forward_with_lse_timing(fa, q, k, v, window)
    run = lambda: fb.flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                         window=window)
    kernel_ms, times = median_ms(run, reps=3)
    _, dev_ms, _ = device_busy(run, 3)
    split = kernel_split(run, 3)
    got = run()
    again = run()
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    # The dk/dv split the wrapper picks, timed against no split (the
    # wrapper's choice swapped out for these calls only), alternating.
    chosen = fb.dkv_splits(b, kh, s, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    by_splits, unsplit = {}, None
    if chosen > 1:
        pick = fb.dkv_splits
        try:
            for n_split in (1, chosen, 1, chosen):
                fb.dkv_splits = lambda *_, n=n_split: n
                by_splits.setdefault(n_split, []).extend(
                    median_ms(run, reps=3)[1])
            fb.dkv_splits = lambda *_: 1
            unsplit = run()
        finally:
            fb.dkv_splits = pick
    res = {}
    fb.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True,
                               window=window)             # warm: allocations
    plain_ms = cuda_ms(lambda: res.update(want=fb.flash_attention_bwd_ref(
        q, k, v, out, lse, do, causal=True, window=window)))
    want = res.pop("want")
    err = max(float((a.float() - w.float()).abs().max())
              for a, w in zip(got, want))
    big = max(float(w.float().abs().max()) for w in want)
    btol = bwd_tol(torch.bfloat16)
    bwd_ok = grads_close(got, want, btol)
    names = ("dq", "dk", "dv")
    close = lambda a, w: bool(torch.allclose(a.float(), w.float(),
                                             atol=btol, rtol=btol))
    for n, a, w in zip(names, got, want):
        rel[n] = rel_err(a, w)
        for c in PLANTED_SCALES:
            planted[f"{n} x {c}"] = (rel_err(a * c, w), close(a * c, w))
    # dk, dv with the second half of each GQA group's q heads left out:
    # what the sum of the splits gives when one of two is dropped.
    g = h // kh
    half = do.clone()
    half[:, [i for i in range(h) if i % g >= g // 2]] = 0
    _, dk_half, dv_half = fb.flash_attention_bwd_ref(
        q, k, v, out, lse, half, causal=True, window=window)
    del half
    for n, a, w in (("dk", dk_half, want[1]), ("dv", dv_half, want[2])):
        planted[f"{n} without q heads {g // 2}-{g - 1} of each group"] = (
            rel_err(a, w), close(a, w))
    del dk_half, dv_half
    rel_unsplit = None if unsplit is None else {
        n: rel_err(a, w) for n, a, w in zip(names, unsplit, want)}
    del want, unsplit
    rel_ok = all(x <= TRAIN_REL_TOL for x in rel.values()) and all(
        x <= TRAIN_REL_TOL for x in (rel_unsplit or {}).values())
    caught = all(x > TRAIN_REL_TOL for x, _ in planted.values())
    lib_ms, _ = median_ms(library_attention_bwd(q, k, v, do, True, window),
                          reps=3)
    bnd, by, n_bytes, flops = flash_bwd_bound(b, h, kh, s, s, dh, 2, True,
                                              window)
    print(f"flash_attention_bwd {name} B={b} H={h} K={kh} S=T={s} dh={dh} "
          f"window={window} bf16 causal: kernel {kernel_ms:.3f} ms/call (of "
          f"{[round(x, 3) for x in times]}; on the card "
          f"{card_text(dev_ms, '.3f')}; kernels a call: "
          f"{card_text(split and ', '.join(split), 's')}), plain "
          f"{plain_ms:.2f} ms, library "
          f"{lib_ms:.3f} ms (SDPA backward), bound {bnd:.4f} ms ({by}; "
          f"{n_bytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP), max abs err "
          f"{err:.3g} (largest gradient {big:.3g}); dq, dk, dv within "
          f"{btol} element by element: {bwd_ok}; two "
          f"calls bit-equal: {repeat}; PERF.md row before the tensor-core "
          f"route {EARLIER_MS['flash_attention_bwd ' + name + ' train']} ms;"
          f" by kernel on the card (ms a call): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    print(f"flash_attention(_bwd) {name} training shape: relative error "
          f"||a - w|| / ||w|| against the plain version (bar "
          f"{TRAIN_REL_TOL}): "
          + ", ".join(f"{k} {x:.3g}" for k, x in rel.items())
          + "; planted faults (each must read above the bar): "
          + ", ".join(f"{k} {x:.3g} (passes the element-by-element bar: "
                      f"{c})" for k, (x, c) in planted.items()), flush=True)
    if by_splits:
        med = {n: sorted(x)[len(x) // 2] for n, x in by_splits.items()}
        print(f"flash_attention_bwd {name}: dk/dv work of each kv tile in "
              f"{chosen} blocks (the wrapper's choice) "
              f"{med[chosen]:.3f} ms/call (readings "
              f"{[round(x, 3) for x in by_splits[chosen]]}), in 1 block "
              f"{med[1]:.3f} ms/call (readings "
              f"{[round(x, 3) for x in by_splits[1]]}); unsplit relative "
              f"errors " + ", ".join(f"{k} {x:.3g}" for k, x in
                                     rel_unsplit.items()), flush=True)
    earlier = EARLIER_MS.get(f"flash_attention with LSE {name} train")
    print(f"flash_attention with LSE {name} training shape: kernel "
          f"{fwd['ms']:.3f} ms/launch"
          + (f" (PERF.md row before the tensor-core route {earlier} ms)"
             if earlier else "")
          + f", on the card {card_text(fwd['card_ms'], '.3f')} ms,"
          f" plain {fwd['plain_ms']:.2f} ms, "
          f"library {fwd['library_ms']:.3f} ms (SDPA forward), bound "
          f"{fwd['bound_ms']:.4f} ms ({fwd['bound_by']}); output within "
          f"{tol} of the plain version: {out_ok} (max abs err "
          f"{out_err:.3g}); LSE rows within 1e-4: {lse_ok}", flush=True)
    if not (bwd_ok and out_ok and lse_ok and repeat and rel_ok and caught):
        raise AssertionError(f"flash_attention (with LSE) or "
                             f"flash_attention_bwd != plain, or two "
                             f"backward calls differ, or a relative error "
                             f"above {TRAIN_REL_TOL} (or a planted fault "
                             f"below it), at {name}")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "max_abs_err": err,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
            "card_ms": dev_ms, "forward": fwd}


# S, T of the backward sweep: the first port's, then the edges of the
# tensor-core route's 64-row tiles.
BWD_LENGTHS = ((1, 1), (77, 300), (256, 256), (300, 77), (63, 65),
               (64, 129), (129, 64), (1, 4096))


def phase_flash_bwd(fa, fb) -> dict:
    """flash_attention's LSE rows and flash_attention_bwd against their
    plain versions on the card over the sweep (and the serving call
    without LSE unchanged), then the recurrentgemma-2b and yi-6b training
    shapes timed.  -> the recurrentgemma-2b shape's numbers (the kernel
    table's)."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    n_cases = n_bad = n_lse_bad = n_changed = 0
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for dh in (32, 64, 128, 256):
            for h, kh in ((4, 4), (32, 4), (10, 1)):
                for s, t in BWD_LENGTHS:
                    for causal in (True, False):
                        for window in (0, 64):
                            lse_ok, same, err, ok = flash_bwd_case(
                                fa, fb, gen, 2, h, kh, s, t, dh, dtype,
                                causal, window)
                            n_cases += 1
                            n_bad += not ok
                            n_lse_bad += not lse_ok
                            n_changed += not same
                            if dtype == torch.float32:
                                worst = max(worst, err)
                            if not (ok and lse_ok and same):
                                print(f"flash_attention_bwd {dtype} dh={dh} "
                                      f"H={h} K={kh} S={s} T={t} causal="
                                      f"{causal} window={window}: max abs "
                                      f"err {err:.3g}, lse ok {lse_ok}, "
                                      f"forward unchanged {same}: FAILED",
                                      flush=True)
    print(f"flash_attention LSE rows: {n_cases - n_lse_bad}/{n_cases} cases "
          f"within 1e-4 of the plain version (+inf where no key is "
          f"visible); forward without LSE bit-equal to it in "
          f"{n_cases - n_changed}/{n_cases}", flush=True)
    print(f"flash_attention_bwd sweep: {n_cases - n_bad}/{n_cases} cases "
          f"within tolerance (f32 {FLASH_BWD_TOL['float32']}, bf16 "
          f"{FLASH_BWD_TOL['bfloat16']}; dh 32/64/128/256 x (H, K) "
          f"(4, 4)/(32, 4)/(10, 1) x S,T "
          f"{' '.join(f'{a}/{b}' for a, b in BWD_LENGTHS)} x causal x "
          f"window 0/64); worst f32 error {worst:.3g}", flush=True)
    if n_bad or n_lse_bad or n_changed:
        raise AssertionError(f"flash_attention_bwd: {n_bad} backward, "
                             f"{n_lse_bad} LSE, {n_changed} forward cases "
                             f"failed")
    rg = flash_bwd_timing(fa, fb, gen, RG, 1, 10, 1, TRAIN_SEQ, 256, 2048)
    flash_bwd_timing(fa, fb, gen, YI, 1, 32, 4, TRAIN_SEQ, 128, 0)
    torch.cuda.empty_cache()
    return rg


def phase_rglru_bwd(rs) -> dict:
    """The rglru_scan backward (one launch walking time in reverse)
    against the plain reverse loop on the card, bit for bit in f32 and
    bf16 (da, dx, dh0), one launch of its counter a call; then timed at
    the training shape."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    n_bad = n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for s in RGLRU_SEQS + (TRAIN_SEQ,):
            for r in RGLRU_WIDTHS:
                for h0 in (False, True):
                    a, x, c = rglru_inputs(gen, 1, s, r, dtype, h0)
                    h = rs.rglru_scan(a, x, c)
                    dh = torch.randn(1, s, r, generator=gen,
                                     device="cuda").to(dtype)
                    n0 = rs.rglru_scan_bwd.launches
                    f0 = rs.rglru_scan.launches
                    got = rs.rglru_scan_bwd(a, h, dh, c)
                    torch.cuda.synchronize()
                    want = rs.rglru_scan_bwd_ref(a, h, dh, c)
                    ok = rs.rglru_scan_bwd.launches == n0 + 1 \
                        and rs.rglru_scan.launches == f0 \
                        and bit_equal(got, want)
                    n_cases += 1
                    n_bad += not ok
                    print(f"rglru_scan backward {dtype} S={s} R={r} "
                          f"h0={h0}: {'bit-equal' if ok else 'DIFFERS'} "
                          f"(da, dx{', dh0' if h0 else ''}; one launch)",
                          flush=True)
    if n_bad:
        raise AssertionError(f"rglru_scan backward != plain in {n_bad} "
                             f"cases")
    a, x, _ = rglru_inputs(gen, 1, TRAIN_SEQ, 2560, torch.float32, False)
    h = rs.rglru_scan(a, x)
    dh = torch.randn(1, TRAIN_SEQ, 2560, generator=gen, device="cuda")
    ms, times = median_ms(lambda: rs.rglru_scan_bwd(a, h, dh), reps=20)
    _, dev_ms, _ = device_busy(lambda: rs.rglru_scan_bwd(a, h, dh), 20)
    got = rs.rglru_scan_bwd(a, h, dh)
    out = {}
    plain_ms = cuda_ms(lambda: out.update(
        want=rs.rglru_scan_bwd_ref(a, h, dh)))
    err = max(float((g - w).abs().max()) for g, w in zip(got[:2],
                                                         out["want"][:2]))
    if not bit_equal(got, out["want"]):
        raise AssertionError("rglru_scan backward != plain at the "
                             "training shape")
    n_bytes = 5 * TRAIN_SEQ * 2560 * 4
    bnd = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"rglru_scan backward sweep: {n_cases}/{n_cases} bit-equal; at "
          f"B=1 S={TRAIN_SEQ} R=2560 f32: {ms:.4f} ms a call (of "
          f"{[round(t, 4) for t in times]}; one launch; on the card "
          f"{card_text(dev_ms)}), plain {plain_ms:.2f} ms, bound "
          f"{bnd:.4f} ms "
          f"(bytes: a, h, dh read and da, dx written once)", flush=True)
    return {"ms": ms, "card_ms": dev_ms, "plain_ms": plain_ms,
            "max_abs_err": err, "bound_ms": bnd, "bound_by": "bytes"}


def train_config(n_layers=None):
    import dataclasses
    from repro_torch.configs import registry
    cfg = registry.get(RG)[0]
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def phase_train_step_parity(fa, fb, rs) -> None:
    """One loss-and-grad at full width, kernel path against plain path:
    recurrentgemma-2b's widths cut to 3 layers (one RG-LRU pair and one
    local attention block, the pattern once), one [1, 4096] microbatch,
    the same parameters and batch; the plain path is autograd of the
    plain versions.  The loss within 0.5 % relative, each block kind's
    gradients within 3 % of their largest magnitude."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, TokenDataset
    from repro_torch.models import lm
    cfg = train_config(3)
    params = lm.init_params(cfg, 0, device="cuda", requires_grad=True)
    batch = {k: torch.from_numpy(v).to("cuda", torch.long) for k, v in
             TokenDataset(DataConfig(cfg.vocab, TRAIN_SEQ, 1, seed=3))
             .batch(0).items()}
    named = dict(params.named_parameters())
    kinds = {name: ("embedding and final norm" if not name.startswith(
        "blocks.") else cfg.blocks()[int(name.split(".")[1])])
        for name in named}
    losses, grads, times = {}, {}, {}
    for path, kw in (("kernel", {}), ("plain", dict(
            flash_attention=fa.flash_attention_ref,
            rglru_scan=rs.rglru_scan_ref))):
        counts = {f: f.launches for f in (fa.flash_attention,
                                          fb.flash_attention_bwd,
                                          rs.rglru_scan, rs.rglru_scan_bwd)}
        for p in named.values():
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = lm.loss_fn(params, cfg, batch, **kw)
        loss.backward()
        torch.cuda.synchronize()
        times[path] = time.perf_counter() - t0
        losses[path] = float(loss.detach())
        grads[path] = {n: p.grad for n, p in named.items()}
        print(f"train step parity, {path} path: loss {losses[path]:.6f}, "
              f"loss and grad {times[path]:.2f} s; launches "
              + ", ".join(f"{f.__name__} {f.launches - c}"
                          for f, c in counts.items()), flush=True)
        if path == "kernel" and (fb.flash_attention_bwd.launches
                                 - counts[fb.flash_attention_bwd] != 1):
            raise AssertionError("the kernel path did not run "
                                 "flash_attention_bwd once")
    for p in named.values():
        p.grad = None
    rel = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    ok = rel <= TRAIN_LOSS_RTOL and np.isfinite(losses["kernel"])
    for kind in sorted(set(kinds.values())):
        names = [n for n in named if kinds[n] == kind]
        big = max(float(grads["plain"][n].abs().max()) for n in names)
        err = max(float((grads["kernel"][n] - grads["plain"][n]).abs()
                        .max()) for n in names)
        good = err <= TRAIN_GRAD_TOL * big and all(
            bool(torch.isfinite(grads["kernel"][n]).all()) for n in names)
        ok = ok and good
        print(f"  {kind} gradients ({len(names)} leaves): max abs diff "
              f"{err:.4g} of largest {big:.4g} ({err / max(big, 1e-30):.3%};"
              f" tolerance {TRAIN_GRAD_TOL:.0%}): "
              f"{'ok' if good else 'FAILED'}", flush=True)
    print(f"train step parity: loss kernel {losses['kernel']:.6f} vs plain "
          f"{losses['plain']:.6f} ({rel:.4%}, tolerance "
          f"{TRAIN_LOSS_RTOL:.1%}): {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError("train step: kernel path != plain path")
    del params, grads, named
    torch.cuda.empty_cache()


def phase_train(fa, fb, rs, ckpt_dir) -> dict:
    """recurrentgemma-2b at its full config trained through
    ``repro_torch.launch.train.main`` for TRAIN_STEPS steps, the four
    counters set to 0 just before and read just after; each must be
    TRAIN_STEPS x its reckoned launches per step, every attention launch
    on the tensor-core route, and no incoming gradient copied before the
    backward.  -> the run's output and numbers."""
    import shutil as sh
    import numpy as np
    import torch
    from repro_torch.launch import train
    from repro_torch.models import lm
    cfg = train_config()
    n = lm.n_params(cfg)
    if n != RG_PARAMS:
        raise AssertionError(f"{RG}: {n} parameters")
    fns = {"flash_attention": fa.flash_attention,
           "flash_attention_bwd": fb.flash_attention_bwd,
           "rglru_scan": rs.rglru_scan,
           "rglru_scan_bwd": rs.rglru_scan_bwd}
    print(f"train {RG}: checkpoints to {ckpt_dir}, disk "
          f"{sh.disk_usage(ckpt_dir)}", flush=True)
    import signal
    handlers = {g: signal.getsignal(g) for g in (signal.SIGTERM,
                                                 signal.SIGUSR1)}
    try:
        for f in fns.values():
            f.launches = 0
            if hasattr(f, "launches_tc"):
                f.launches_tc = 0
        fb.FlashAttentionFn.do_copies = 0
        t0 = time.perf_counter()
        out = train.main(TRAIN_ARGS + ["--ckpt-dir", str(ckpt_dir)],
                         device="cuda")
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in fns.items()}
        routes = {k: f.launches_tc for k, f in fns.items()
                  if hasattr(f, "launches_tc")}
        copies = fb.FlashAttentionFn.do_copies
    finally:
        for g, h in handlers.items():       # main() installed the trainer's
            signal.signal(g, h)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_local = cfg.blocks().count("local_attn")
    n_rglru = cfg.blocks().count("rglru")
    mb = TRAIN_MICROBATCHES
    per_step = {"flash_attention": n_local * mb * 2,
                "flash_attention_bwd": n_local * mb,
                "rglru_scan": n_rglru * mb * 2,
                "rglru_scan_bwd": n_rglru * mb}
    want = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    hist = out["history"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    dts = [h["dt"] for h in hist]
    step_s = float(np.mean(dts[1:])) if len(dts) > 1 else dts[0]
    mfu = 6 * n * tokens / step_s / BF16_OPS_PER_S
    finite = all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                 for h in hist)
    print(f"train {RG}: {n} parameters, {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {mb} microbatches, "
          f"{wall:.1f} s in main (init, steps, final save); step times "
          f"{[round(d, 3) for d in dts]} s; steps 2-{TRAIN_STEPS}: "
          f"{step_s:.3f} s a step, {tokens / step_s:.0f} tokens/s, MFU "
          f"{mfu:.2%} (6 N tokens / step time / {BF16_OPS_PER_S:.3g}); "
          f"losses {[round(h['loss'], 4) for h in hist]}, grad norms "
          f"{[round(h['grad_norm'], 4) for h in hist]}; "
          f"max_memory_allocated {peak:.2f} GiB", flush=True)
    print(f"train {RG}: launches {launches}, reckoned {want} "
          f"({n_local} local blocks x {mb} microbatches x (forward + "
          f"recompute); {n_local} x {mb} backward calls; {n_rglru} RG-LRU "
          f"blocks x {mb} x 2 forward (forward and recompute), and x {mb} "
          f"x 1 backward launch, x {TRAIN_STEPS} steps)", flush=True)
    print(f"train {RG}: tensor-core route launches {routes} (every "
          f"attention call bf16: {per_step['flash_attention']} and "
          f"{per_step['flash_attention_bwd']} a step); incoming gradients "
          f"copied before flash_attention_bwd: {copies} (none may be)",
          flush=True)
    if not finite or out["step"] != TRAIN_STEPS or launches != want \
            or any(n != want[k] for k, n in routes.items()) or copies:
        raise AssertionError(f"training {RG} failed: step {out['step']}, "
                             f"finite {finite}, launches {launches}, "
                             f"tensor-core route {routes}, copies of the "
                             f"incoming gradient {copies}")
    return {"out": out, "launches": launches, "routes": routes,
            "step_s": step_s, "mfu": mfu,
            "peak_gib": peak,
            "save_s": [h["ckpt_s"] for h in hist if "ckpt_s" in h]}


def phase_checkpoint(out, ckpt_dir, save_s) -> None:
    """The trainer's final save (params, m, v, count; ``save_s``: the
    seconds of its saves) restored into a fresh Trainer: every leaf equal
    bit for bit, ``latest()`` the step; the seconds to read."""
    import torch
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves
    cfg = train_config()
    state = {"params": out["params"].tree(), "opt": out["opt"]}
    size = sum(x.numel() * x.element_size() for x in leaves(state))
    torch.cuda.empty_cache()
    fresh = Trainer(cfg, TrainerConfig(
        total_steps=TRAIN_STEPS, ckpt_dir=str(ckpt_dir),
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        microbatches=TRAIN_MICROBATCHES), device="cuda")
    latest = fresh.ckpt.latest()
    t0 = time.perf_counter()
    params, opt_state, step = fresh.init_or_restore()
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    got = fresh.state_tree(params, opt_state)
    bad = [i for i, (a, b) in enumerate(zip(leaves(state), leaves(got)))
           if a.dtype != b.dtype or not torch.equal(a, b)]
    on_disk = sum(f.stat().st_size for f in
                  (Path(ckpt_dir) / f"step_{TRAIN_STEPS}").iterdir())
    print(f"checkpoint round trip: {len(leaves(state))} leaves, "
          f"{size / 1e9:.2f} GB of params, m, v and count, {on_disk / 1e9:.2f}"
          f" GB on disk; the trainer's save {[round(x, 1) for x in save_s]} "
          f"s, init and restore into a fresh Trainer {read_s:.1f} s; "
          f"latest() {latest}, step {step}; leaves differing: {len(bad)}",
          flush=True)
    del params, opt_state, got, fresh
    torch.cuda.empty_cache()
    if bad or latest != TRAIN_STEPS or step != TRAIN_STEPS:
        raise AssertionError("checkpoint round trip failed")


# The port's profiler ranges in a training step: the forward and the
# optimizer (train/step.py), each block (models/lm.py) and the two
# autograd Functions' backwards.
STEP_RANGES = ("repro_torch.forward", "repro_torch.block",
               "repro_torch.flash_attention_bwd", "repro_torch.rglru_scan_bwd",
               "repro_torch.optimizer")


def step_split(events, device_type) -> tuple:
    """A profiled training step's card time (ms) split by the port's
    ranges.  A kernel or copy belongs to the ranges that were open on the
    host when it was launched: its launch is the runtime or driver call
    with the same correlation id (the kernels that the port's libraries
    launch through ctypes are linked to no PyTorch op, so this is the one
    link all of them have).  The forward and the optimizer run on the
    calling thread and the backward on autograd's, one after the other, so
    the time of the launch decides.  A block range inside the forward
    range is the forward's, outside it remat's recompute; the rest of the
    forward range is the embedding, unembedding and loss; what no range
    covers is the rest of the backward.  -> (split, card ms in all,
    {range: count}, kernels in the attention backward's ranges, kernels
    with no launch found)."""
    names = ["forward (blocks)", "forward (embedding, unembedding, loss)",
             "recompute", "attention backward", "scan backward", "optimizer"]
    split = dict.fromkeys(names + ["rest of the backward"], 0.0)
    count = dict.fromkeys(STEP_RANGES, 0)
    ranges, launched = [], {}
    for e in events:
        if e.device_type != device_type.CPU:
            continue
        if e.name in count:
            count[e.name] += 1
            ranges.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name.startswith("cu"):               # cudaLaunchKernel, ...
            launched[e.id] = e.time_range.start
    attn_kernels = lost = 0
    for e in card_events(events, device_type):
        t = launched.get(e.id)
        lost += t is None
        open_ = set() if t is None else {
            name for a, b, name in ranges if a <= t <= b}
        if "repro_torch.flash_attention_bwd" in open_:
            key = "attention backward"
            attn_kernels += 1
        elif "repro_torch.rglru_scan_bwd" in open_:
            key = "scan backward"
        elif "repro_torch.block" in open_:
            key = "forward (blocks)" if "repro_torch.forward" in open_ \
                else "recompute"
        elif "repro_torch.forward" in open_:
            key = "forward (embedding, unembedding, loss)"
        elif "repro_torch.optimizer" in open_:
            key = "optimizer"
        else:
            key = "rest of the backward"
        split[key] += e.time_range.elapsed_us() / 1e3
    return split, sum(split.values()), count, attn_kernels, lost


def phase_train_profile(out) -> None:
    """Where a training step's time goes: one step of the trainer's own
    step function (``make_train_step``, as ``Trainer`` builds it) on the
    trained state under ``torch.profiler`` (after one traced for warm-up),
    its card time split by the port's ranges (``step_split``); the wall
    time of one more step with the profiler off, and the device idle
    share.  Runs after the checkpoint was checked."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.data.pipeline import DataConfig, TokenDataset
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import make_train_step
    cfg = train_config()
    params, opt_state = out["params"], out["opt"]
    step_fn = make_train_step(
        cfg, AdamW(state_dtype=cfg.opt_state_dtype),
        cosine_schedule(3e-3, 10, TRAIN_STEPS),
        microbatches=TRAIN_MICROBATCHES)
    data = TokenDataset(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH))
    box = {"step": out["step"]}

    def one_step():
        batch = {k: torch.from_numpy(v).to("cuda", torch.long)
                 for k, v in data.batch(box["step"]).items()}
        box["step"] = step_fn(params, opt_state, box["step"], batch)[2]
        torch.cuda.synchronize()
    n_local = cfg.blocks().count("local_attn")
    n_rglru = cfg.blocks().count("rglru")
    mb = TRAIN_MICROBATCHES
    want = {"repro_torch.forward": mb, "repro_torch.block": 2 * mb * len(
        cfg.blocks()), "repro_torch.flash_attention_bwd": mb * n_local,
        "repro_torch.rglru_scan_bwd": mb * n_rglru,
        "repro_torch.optimizer": 1}
    # Each of these ranges launches a kernel or more.
    events = profiled(one_step, 1, sum(want.values()))
    t0 = time.perf_counter()
    one_step()
    wall = (time.perf_counter() - t0) * 1e3
    if events is None:
        print(f"train {RG} one step: {wall:.1f} ms wall; its card time and "
              f"ranges not measured (no complete trace)", flush=True)
        return
    split, busy, count, attn_kernels, lost = step_split(events, DeviceType)
    print(f"train {RG} one step's card time by the port's profiler ranges "
          f"({busy:.1f} ms in all): " + ", ".join(
              f"{k} {v:.1f} ms ({v / busy:.1%})" for k, v in split.items())
          + f"; ranges {count} (reckoned {want}); {attn_kernels} kernels "
          f"in the attention backward's ranges; {lost} kernels and copies "
          f"with no launch found", flush=True)
    print(f"train {RG} one step: {wall:.1f} ms wall, {busy:.1f} ms of "
          f"kernels and copies on the card (torch.profiler), device idle "
          f"share {1 - busy / wall:.1%}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if count != want:
        raise AssertionError("the step's profiler ranges are not as "
                             "reckoned")


class Laps:
    """Each phase's wall time (since the previous lap), for the record."""

    def __init__(self):
        self.t0 = self.t = time.time()
        self.laps = {}

    def lap(self, name: str) -> None:
        now = time.time()
        self.laps[name] = round(now - self.t, 1)
        self.t = now

    def line(self) -> str:
        return (f"phase times (s): {self.laps}; total "
                f"{time.time() - self.t0:.1f} s")


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
        from repro_torch.configs import registry
        from repro_torch.core import simlock as sl
        from repro_torch.kernels import build, simstep
        from repro_torch.kernels import mlstm_scan as ms
        from repro_torch.kernels import decode_attention as da
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import flash_attention_bwd as fb
        from repro_torch.kernels import rglru_scan as rs
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e}); run from "
              f"the repository root", file=sys.stderr)
        return 1
    try:
        laps = Laps()
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
        frames = stack_frames(build, "simstep")
        print(f"fused_chunk stack frames (ptxas, bytes): {frames}",
              flush=True)
        if not frames or any(frames.values()):
            raise AssertionError("fused_chunk keeps a stack frame")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        laps.lap("1 build")
        run_plain_jobs(sl, simstep)
        laps.lap("2, 3c, 3d kernel vs plain")
        shape = phase_main_shape(sl, simstep)
        main_run = phase_main(sl, simstep)
        laps.lap("2-3 main path")
        figures = phase_figures(sl, simstep)
        laps.lap("3b")
        load = phase_load_figures(sl, simstep)
        laps.lap("3c")
        keyshard = phase_keyshard(sl, simstep)
        laps.lap("3d")
        closed = phase_closed(sl, simstep)
        laps.lap("3e")
        api = phase_api(sl, simstep, closed)
        laps.lap("3f")
        phase_example()
        laps.lap("3g")
        phase_fleet()
        laps.lap("3h fleet")
        mlstm = phase_mlstm(ms, build)
        serve_run = phase_serve(ms)
        phase_model(ms)
        laps.lap("4-6 xlstm-125m")
        flash = phase_flash(fa)
        dec = phase_decode(da)
        laps.lap("7-8 attention")
        params = phase_yi_model(fa, da)
        attn = {"flash_attention": fa.flash_attention,
                "decode_attention": da.decode_attention}
        yi_launches, rate, slo = phase_serve_once(
            YI, registry.get(YI)[0], attn, params, with_decode=False)
        del params
        torch.cuda.empty_cache()
        phase_yi_cli(rate, slo)
        laps.lap("9-10 yi-6b")
        rglru = phase_rglru(rs, build)
        params = phase_rg_model(rs, fa, da)
        rg_launches, _, _ = phase_serve_once(
            RG, registry.get(RG)[0], {"rglru_scan": rs.rglru_scan, **attn},
            params,
            with_decode=True)
        if rg_launches["rglru_scan"] <= rg_launches["rglru_scan decode"]:
            raise AssertionError(f"the {RG} serving path launched no "
                                 f"rglru_scan prefill: {rg_launches}")
        del params
        torch.cuda.empty_cache()
        laps.lap("11-13 recurrentgemma-2b")
        gemma = phase_gemma_kernels(fa, da)
        params = phase_gemma_model(fa, da)
        gemma_launches, _, _ = phase_serve_once(
            GEMMA, registry.get(GEMMA)[0], attn, params, with_decode=True)
        del params
        torch.cuda.empty_cache()
        laps.lap("13b-13d gemma-7b")
        cut = phase_cut_models(fa, da, laps)
        llava = phase_llava(fa, da)
        laps.lap(f"13i {LLAVA}")
        hubert = phase_hubert(fa, fb, da)
        laps.lap(f"13j {HUBERT}")
        t0 = time.time()
        flash_bwd = phase_flash_bwd(fa, fb)
        rglru_bwd = phase_rglru_bwd(rs)
        phase_train_step_parity(fa, fb, rs)
        print(f"training kernel phases: {time.time() - t0:.1f} s", flush=True)
        import shutil
        import tempfile
        ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        try:
            t0 = time.time()
            trained = phase_train(fa, fb, rs, ckpt_dir)
            print(f"training phase: {time.time() - t0:.1f} s", flush=True)
            t0 = time.time()
            phase_checkpoint(trained["out"], ckpt_dir, trained["save_s"])
            print(f"checkpoint phase: {time.time() - t0:.1f} s", flush=True)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        t0 = time.time()
        phase_train_profile(trained["out"])
        print(f"training profile phase: {time.time() - t0:.1f} s",
              flush=True)
        train_launches = trained["launches"]
        del trained
        torch.cuda.empty_cache()
        laps.lap("14-19 training")
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
        launches=serve_run["launches"],
        launches_by_shape=serve_run["by_shape"],
        max_abs_err=mlstm["max_abs_err"], ms=mlstm["ms"],
        card_ms=mlstm["card_ms"], plain_ms=mlstm["plain_ms"],
        bound_ms=mlstm["bound_ms"], bound_by=mlstm["bound_by"],
        library_ms=None, blocks=mlstm["blocks"],
        decode_shape=mlstm["decode"]), dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:43",
        launches=rg_launches["rglru_scan"] + train_launches["rglru_scan"],
        launches_by_shape={
            f"{RG} serve prefill": rg_launches["rglru_scan"]
            - rg_launches["rglru_scan decode"],
            f"{RG} serve decode (S=1)": rg_launches["rglru_scan decode"],
            f"{RG} train forward and recompute":
                train_launches["rglru_scan"]},
        max_abs_err=rglru["serving prefill"]["max_abs_err"],
        **{k: rglru["serving prefill"][k] for k in (
            "ms", "card_ms", "plain_ms", "bound_ms", "bound_by")},
        library_ms=None, decode_shape=rglru["decode"],
        train_forward=rglru["training forward"]), dict(
        name="rglru_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:43",
        launches=train_launches["rglru_scan_bwd"],
        launches_by_shape={
            f"{RG} train backward": train_launches["rglru_scan_bwd"]},
        **{k: rglru_bwd[k] for k in (
            "max_abs_err", "ms", "card_ms", "plain_ms", "bound_ms",
            "bound_by")},
        library_ms=None), dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention_bwd.py:162",
        launches=train_launches["flash_attention_bwd"],
        max_abs_err=flash_bwd["max_abs_err"], ms=flash_bwd["ms"],
        plain_ms=flash_bwd["plain_ms"], bound_ms=flash_bwd["bound_ms"],
        bound_by=flash_bwd["bound_by"],
        library_ms=flash_bwd["library_ms"])] + [dict(
        name=name, route="cuda",
        source=f"src/repro_torch/kernels/csrc/{name}.cu", replaces=where,
        launches=yi_launches[name],
        launches_by_path={f"{YI} serve": yi_launches[name],
                          f"{RG} serve": rg_launches[name],
                          f"{GEMMA} serve": gemma_launches[name],
                          f"{RG} train (forward and recompute)":
                              train_launches.get(name, 0)},
        max_abs_err=r["max_abs_err"],
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"])
        for name, where, r in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:94",
             flash),
            ("decode_attention", "src/repro/kernels/decode_attention.py:70",
             dec))]
    for row in kernels:
        if row["name"] in gemma:
            row["gemma_shape"] = dict(gemma[row["name"]],
                                      launches=gemma_launches[row["name"]])
            row["cut_model_shapes"] = {
                arch: dict(shapes[row["name"]], group=group,
                           launches=launches[row["name"]])
                for arch, (shapes, launches, group) in cut.items()}
            row["launches_by_path"].update({
                f"{arch} serve (cut)": launches[row["name"]]
                for arch, (_, launches, _) in cut.items()})
            row["llava_shape"] = dict(
                llava["kernels"][row["name"]],
                launches=llava["launches"][row["name"]])
            row["launches_by_path"][
                f"{LLAVA} prefill and {FRONTEND_DECODE} decode steps"] = \
                llava["launches"][row["name"]]
        if row["name"] == "flash_attention":
            row["train_shape"] = dict(flash_bwd["forward"], launches=(
                train_launches["flash_attention"]))
            row["hubert_dh80_shapes"] = hubert["shapes"]
            row["launches_by_path"][f"{HUBERT} forward"] = \
                hubert["launches"]["flash_attention"]
        if row["name"] == "decode_attention":
            row.update(
                launches_split=yi_launches["decode_attention split"],
                card_ms=dec["card_ms"],
                library_card_ms=dec["library_card_ms"], splits=dec["splits"],
                blocks=dec["blocks"], unsplit_ms=dec["unsplit_ms"],
                rg_shape={k: dec["rg"][k] for k in (
                    "ms", "card_ms", "library_card_ms", "splits", "blocks",
                    "unsplit_ms",
                    "bound_ms", "library_ms", "max_abs_err")})
        if row["name"] == "fused_chunk":
            row.update({k: main_run[k] for k in (
                "wall_s", "events_per_s", "launches_past_end",
                "init_sweep_ms", "simulate_ms", "card_ms", "outside_ms")})
            row["launches_by_path"] = {
                "fig1 main path": main_run["launches"],
                "figure grids": figures["launches"],
                "load figures": load["launches"],
                "keyshard figure": keyshard["launches"],
                "closed-loop figures": closed["launches"],
                "simulator API": api["launches"]}
            row["figures"] = {k: {f: r[f] for f in (
                "instantiation", "cells", "events", "launches", "wall_s",
                "events_per_s", "ms", "bound_ms", "bound_by") if f in r}
                for k, r in {**figures["grids"], **load["grids"],
                             **keyshard["grids"], **closed["grids"],
                             "amp_config libasl": api["amp"]}.items()}
    print(laps.line(), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
