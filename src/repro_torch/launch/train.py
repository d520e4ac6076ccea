"""Training launcher:
``python -m repro_torch.launch.train --arch recurrentgemma-2b``.

Trains the architecture's published config (random init from seed 0,
the synthetic token stream) on the CUDA device through the port's
kernels: ``flash_attention`` forward with its log-sum-exp rows and
``flash_attention_bwd`` in every attention block, ``rglru_scan`` forward
and, reversed, backward in every RG-LRU block.  ``--tiny`` takes the
reduced same-family config; ``main(argv, device="cpu")`` runs the plain
versions on the CPU (the tests do).  xlstm-125m raises: its mLSTM and
sLSTM have no backward in the port yet.  A mixture-of-experts config
(phi3.5-moe, grok-1) raises too: its routing and expert products have no
backward held against the reference yet.  So does a config with a
modality frontend (llava-next-mistral-7b, hubert-xlarge): the synthetic
stream yields tokens only (the reference's trainer fails there on the
missing ``patch_embeds`` / ``frames``).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import registry
from repro_torch.device import resolve
from repro_torch.models import lm
from repro_torch.train.trainer import Trainer, TrainerConfig

# Block kinds with a backward in the port.
TRAINABLE = ("attn", "local_attn", "rglru")


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", type=str, default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)

    if args.tiny:
        cfg = registry.get_tiny(args.arch)
    else:
        cfg, _meta = registry.get(args.arch)
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: training a {cfg.frontend!r} frontend is not "
            f"ported to repro_torch yet (the data source yields tokens "
            f"only; a later slice)")
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts training is not ported to "
            f"repro_torch yet (a later slice)")
    untrainable = sorted(set(cfg.blocks()) - set(TRAINABLE))
    if untrainable:
        raise NotImplementedError(
            f"{cfg.name}: the {untrainable} blocks have no backward in "
            f"repro_torch yet, so it cannot train")
    dev = resolve(device)

    t = Trainer(cfg, TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, lr=args.lr,
        microbatches=args.microbatches, global_batch=args.global_batch,
        seq_len=args.seq_len), device=dev)
    t.install_signal_handlers()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = t.run()
    hist = out["history"]
    for h in hist:
        print(f"step {h['step']}: loss {h['loss']:.4f} grad_norm "
              f"{h['grad_norm']:.4f} lr {h['lr']:.3g} {h['dt']:.3f} s",
              flush=True)
    peak = (f" peak_memory={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
            f"GiB" if dev.type == "cuda" else "")
    losses = (f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
              if hist else "no steps run ")
    print(f"arch={cfg.name} params={lm.n_params(cfg)} steps={out['step']} "
          f"{losses}stragglers={len(out['stragglers'])} "
          f"preempted={out['preempted']}{peak}", flush=True)
    return out


if __name__ == "__main__":
    main()
