"""Quickstart on the PyTorch/CUDA port: train a small LM end to end with
checkpoint and restart.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The port's counterpart of ``examples/quickstart.py``: trains a reduced
yi-6b-family config (yi-6b-tiny with 32-dimensional heads,
``configs.yi_6b.tiny_card``) on the synthetic Markov stream for 60 steps
(the loss drops from about ln(vocab) toward the stream's conditional
entropy), simulates a preemption at step 30, restarts from the checkpoint
in a fresh ``Trainer``, and checks that the resumed run finishes.
``--device``
defaults to the CUDA device (raises without one); ``cpu`` runs the plain
PyTorch versions of the kernels.
"""

import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.yi_6b import tiny_card              # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def main(total_steps=60, preempt_at=30, ckpt_every=10, global_batch=8,
         seq_len=64, lr=3e-3, check_loss=True, device=None):
    """Parameterized so the tests can run it with tiny arguments on the
    CPU; the defaults reproduce the demo."""
    cfg = tiny_card()
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainerConfig(total_steps=total_steps,
                             ckpt_every=ckpt_every, ckpt_dir=d,
                             lr=lr, global_batch=global_batch,
                             seq_len=seq_len)

        print(f"== phase 1: train {preempt_at} steps, then 'preempt' ==")
        t1 = Trainer(cfg, tcfg, device=device)
        out1 = t1.run(max_steps=preempt_at)
        print(f"   step={out1['step']} "
              f"loss {out1['history'][0]['loss']:.3f} -> "
              f"{out1['history'][-1]['loss']:.3f}")

        print("== phase 2: fresh trainer restores from checkpoint ==")
        t2 = Trainer(cfg, tcfg, device=device)
        if t2.ckpt.latest() != preempt_at:
            raise RuntimeError(f"latest checkpoint {t2.ckpt.latest()}, "
                               f"expected {preempt_at}")
        out2 = t2.run()
        print(f"   resumed at {preempt_at}, finished at "
              f"step={out2['step']} "
              f"final loss {out2['history'][-1]['loss']:.3f}")
        if out2["step"] != total_steps:
            raise RuntimeError(f"finished at {out2['step']}")
        if check_loss and \
                out2["history"][-1]["loss"] >= out1["history"][0]["loss"]:
            raise RuntimeError("the loss did not decrease")
        print("quickstart OK: loss decreased and restart was seamless")
        return out2


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    main(device=ap.parse_args().device)
