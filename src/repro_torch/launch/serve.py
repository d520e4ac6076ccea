"""Serving launcher: continuous batching with a selectable admission policy.

``python -m repro_torch.launch.serve --arch xlstm-125m --scheduler asl``
times real prefill / decode steps of the model on the CUDA device (random
weights from a seed, the config's compute dtype), calibrates the engine's
cost model from them, then drives the engine with a Poisson stream of
requests under the chosen admission scheduler and prints throughput and
the TTFT / ITL tails against the SLO.
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
                    device=None, seed=0) -> CostModel:
    """Measure real step times of the model: the mean of 5 prefills of
    ``prefill_chunk`` tokens and of 20 decode steps, each of ``batch``
    sequences, after one untimed call of each.  On the card the host
    clock brackets work that ends in ``torch.cuda.synchronize``."""
    dev = resolve(device)
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


def main(argv=None, *, device=None):
    """Calibrate on ``device`` (None: the CUDA device), serve, print.
    Returns the engine's metrics plus the calibrated ``decode_step_s`` and
    ``prefill_chunk_s``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--scheduler", choices=["fifo", "greedy", "asl"],
                    default="asl")
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--slo-ttft", type=float, default=0.25)
    args = ap.parse_args(argv)

    cfg = registry.get_tiny(args.arch) if args.tiny \
        else registry.get(args.arch)[0]
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; no serving path")
    cost = calibrated_cost(cfg, device=device)
    print(f"calibrated: decode={cost.decode_step_s*1e3:.2f}ms "
          f"prefill_chunk={cost.prefill_chunk_s*1e3:.2f}ms")
    kw = {"default_window": 0.02, "max_window": 10.0} \
        if args.scheduler == "asl" else {}
    eng = ServingEngine(args.scheduler, cost, scheduler_kwargs=kw)
    poisson_workload(eng, rate_rps=args.rate, duration_s=args.duration,
                     prompt_lens=[512, 1024, 2048], new_tokens=[32, 128],
                     slo_ttft=args.slo_ttft)
    m = eng.metrics()
    if m["n"] == 0:
        print(f"scheduler={args.scheduler} n=0: no request finished in "
              f"{args.duration} s at {args.rate} requests/s")
    else:
        print(f"scheduler={args.scheduler} n={m['n']} "
              f"tok/s={m['throughput_tok_s']:.0f} "
              f"ttft_p99={m['ttft_p99']*1e3:.1f}ms "
              f"itl_p99={m['itl_p99']*1e3:.1f}ms "
              f"viol={m['slo_violation_rate']:.1%}")
    return {**m, "decode_step_s": cost.decode_step_s,
            "prefill_chunk_s": cost.prefill_chunk_s}


if __name__ == "__main__":
    main()
