"""Serving launcher: continuous batching with a selectable admission policy.

``python -m repro_torch.launch.serve --arch yi-6b --scheduler asl fifo``
times real prefill / decode steps of the model on the CUDA device (random
weights from a seed, the config's compute dtype), calibrates the engine's
cost model from them once, then drives the engine with a Poisson stream
of requests under each chosen admission scheduler, on that one cost
model, and prints throughput and the TTFT / ITL tails against the SLO.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import registry
from repro_torch.device import resolve
from repro_torch.models import lm
from repro_torch.serving.engine import CostModel, ServingEngine, \
    poisson_workload


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def calibrated_cost(cfg, *, batch=8, prefill_chunk=256, t_cache=512,
                    device=None, seed=0, params=None) -> CostModel:
    """Measure real step times of the model: the mean of 5 prefills of
    ``prefill_chunk`` tokens and of 20 decode steps, each of ``batch``
    sequences, after one untimed call of each.  On the card the host
    clock brackets work that ends in ``torch.cuda.synchronize``.  Random
    parameters from ``seed`` unless ``params`` are given."""
    dev = resolve(device)
    if params is None:
        params = lm.init_params(cfg, seed, device=dev)
    toks = torch.ones((batch, prefill_chunk), dtype=torch.long, device=dev)
    logits, cache = lm.prefill(params, cfg, {"tokens": toks},
                               lm.init_cache(cfg, batch, t_cache, dev))
    lengths = torch.full((batch,), prefill_chunk, dtype=torch.int32,
                         device=dev)
    tok = torch.ones((batch, 1), dtype=torch.long, device=dev)
    logits2, cache, lengths = lm.decode_step(params, cfg, tok, lengths,
                                             cache)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(5):
        logits, _ = lm.prefill(params, cfg, {"tokens": toks},
                               lm.init_cache(cfg, batch, t_cache, dev))
    _sync(dev)
    t_pre = (time.perf_counter() - t0) / 5
    t0 = time.perf_counter()
    for _ in range(20):
        logits2, cache, lengths = lm.decode_step(params, cfg, tok, lengths,
                                                 cache)
    _sync(dev)
    t_dec = (time.perf_counter() - t0) / 20
    return CostModel(decode_step_s=t_dec, prefill_chunk_s=t_pre,
                     prefill_chunk=prefill_chunk, max_batch=batch)


PROMPT_LENS, NEW_TOKENS = [512, 1024, 2048], [32, 128]


def serve(cost: CostModel, scheduler: str, *, rate: float, duration: float,
          slo_ttft: float) -> dict:
    """Drive the engine under ``scheduler`` with a Poisson stream of
    ``rate`` requests/s for ``duration`` simulated seconds (prompts of
    ``PROMPT_LENS`` tokens, ``NEW_TOKENS`` new ones) -> its metrics."""
    kw = {"default_window": 0.02, "max_window": 10.0} \
        if scheduler == "asl" else {}
    eng = ServingEngine(scheduler, cost, scheduler_kwargs=kw)
    poisson_workload(eng, rate_rps=rate, duration_s=duration,
                     prompt_lens=PROMPT_LENS, new_tokens=NEW_TOKENS,
                     slo_ttft=slo_ttft)
    return eng.metrics()


def main(argv=None, *, device=None):
    """Calibrate on ``device`` (None: the CUDA device), serve under each
    scheduler, print.  Returns the first scheduler's metrics plus the
    calibrated ``decode_step_s`` and ``prefill_chunk_s``, and every
    scheduler's metrics under ``by_scheduler``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--scheduler", nargs="+", default=["asl"],
                    choices=["fifo", "greedy", "asl"])
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--slo-ttft", type=float, default=0.25)
    args = ap.parse_args(argv)

    cfg = registry.get_tiny(args.arch) if args.tiny \
        else registry.get(args.arch)[0]
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; no serving path")
    print(f"{cfg.name}: {lm.n_params(cfg)} parameters "
          f"({cfg.param_dtype} at rest, {cfg.dtype} compute)", flush=True)
    cost = calibrated_cost(cfg, device=device)
    print(f"calibrated: decode={cost.decode_step_s*1e3:.2f}ms "
          f"prefill_chunk={cost.prefill_chunk_s*1e3:.2f}ms", flush=True)
    runs = {}
    for sched in args.scheduler:
        m = runs[sched] = serve(cost, sched, rate=args.rate,
                                duration=args.duration,
                                slo_ttft=args.slo_ttft)
        if m["n"] == 0:
            print(f"scheduler={sched} n=0: no request finished in "
                  f"{args.duration} s at {args.rate} requests/s")
        else:
            print(f"scheduler={sched} n={m['n']} "
                  f"tok/s={m['throughput_tok_s']:.0f} "
                  f"ttft_p99={m['ttft_p99']*1e3:.1f}ms "
                  f"itl_p99={m['itl_p99']*1e3:.1f}ms "
                  f"viol={m['slo_violation_rate']:.1%}", flush=True)
    return {**runs[args.scheduler[0]], "decode_step_s": cost.decode_step_s,
            "prefill_chunk_s": cost.prefill_chunk_s, "by_scheduler": runs}


if __name__ == "__main__":
    main()
