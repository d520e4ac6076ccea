#!/usr/bin/env python3
"""Time a model's serving and training steps on the card, from any tree of
the port (this one, or a parent commit unpacked with ``git archive``), so
two trees can be compared in turns in one call on one card.

    python3 tools/time_model_steps.py [TREE] [--arch recurrentgemma-2b]
        [--no-train]

Builds the tree's kernels (into the tree's own build directory), then, at
the architecture's full config with random weights from seed 0: the
prefill chunk (8 x 256 tokens into a 512-slot cache) and the decode step
(8 sequences), each the median of 5 timed calls after one untimed; and,
unless ``--no-train``, one training step of 2 x 4096 tokens in 2
microbatches (the recurrentgemma-2b trainer's shape), the median of 3
after one untimed.  Each time is the host clock around work that ends in
``torch.cuda.synchronize``.  Prints one JSON line with the tree, the card
(``nvidia-smi``'s name and power limit) and the times.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _timed(fn, n: int) -> list:
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--no-train", action="store_true")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_model_steps: no CUDA device")
    from repro_torch.configs import registry
    from repro_torch.kernels import build
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    t0 = time.time()
    build.build()
    built_s = time.time() - t0
    cfg = registry.get(args.arch)[0]
    res = {"tree": str(tree), "arch": cfg.name, "card": card,
           "build_s": round(built_s, 1)}
    params = lm.init_params(cfg, 0, device="cuda")
    b, s = 8, 256
    toks = torch.ones((b, s), dtype=torch.long, device="cuda")
    tok = torch.ones((b, 1), dtype=torch.long, device="cuda")
    _, cache = lm.prefill(params, cfg, {"tokens": toks},
                          lm.init_cache(cfg, b, 2 * s, "cuda"))
    lengths = torch.full((b,), s, dtype=torch.int32, device="cuda")
    pre = _timed(lambda: lm.prefill(params, cfg, {"tokens": toks},
                                    lm.init_cache(cfg, b, 2 * s, "cuda")), 5)
    dec = _timed(lambda: lm.decode_step(params, cfg, tok, lengths, cache), 5)
    res["prefill_ms"] = [round(x * 1e3, 3) for x in pre]
    res["decode_ms"] = [round(x * 1e3, 3) for x in dec]
    res["prefill_median_ms"] = round(statistics.median(pre) * 1e3, 3)
    res["decode_median_ms"] = round(statistics.median(dec) * 1e3, 3)
    del params, cache
    torch.cuda.empty_cache()
    if not args.no_train:
        from repro_torch.optim.adamw import AdamW, cosine_schedule
        from repro_torch.train.step import make_train_step
        params = lm.init_params(cfg, 0, device="cuda", requires_grad=True)
        opt = AdamW(state_dtype=cfg.opt_state_dtype)
        state = {"opt": opt.init(params), "step": 0}
        step_fn = make_train_step(cfg, opt, cosine_schedule(3e-4, 10, 100),
                                  microbatches=2)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab, (2, 4096), generator=gen,
                                  device="cuda") for k in ("tokens",
                                                           "labels")}

        def train():
            _, state["opt"], _, m = step_fn(params, state["opt"],
                                            state["step"], batch)
            state["step"] += 1
            state["loss"] = float(m["loss"])
        tr = _timed(train, 3)
        res["train_step_s"] = [round(x, 4) for x in tr]
        res["train_median_s"] = round(statistics.median(tr), 4)
        res["loss"] = state["loss"]
        res["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30,
                                2)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
