"""Bounded-staleness straggler mitigation on the PyTorch/CUDA port: the
paper's lock ordering applied to gradient commits.

    PYTHONPATH=src python examples/straggler_training_torch.py
    PYTHONPATH=src python examples/straggler_training_torch.py --device cpu

The port's counterpart of ``examples/straggler_training.py``: simulates an
8-pod data-parallel job with transient stragglers (10 % of steps take 5x)
and compares synchronous training, unbounded async, and the AIMD-windowed
policy (host-side; each row equals the JAX package's).  Then runs a live
2-trainer demonstration on gemma-7b-tiny: two ``Trainer`` instances on the
device sharing a ``BoundedStalenessController``, one artificially slowed.
``--device`` defaults to the CUDA device (raises without one); ``cpu``
runs the plain PyTorch versions of the kernels.
"""

import pathlib
import sys
import tempfile
import threading
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import registry                       # noqa: E402
from repro_torch.dist.staleness import (                       # noqa: E402
    BoundedStalenessController, simulate)
from repro_torch.train.trainer import Trainer, TrainerConfig   # noqa: E402


def simulation() -> dict:
    """The 8-pod simulation; -> {policy: (steps/s, mean staleness, p99
    staleness)}."""
    print("== simulation: 8 pods, 10% of steps straggle 5x ==")
    kw = dict(straggle_prob=0.1, straggle_factor=5.0, seed=11,
              horizon_steps=300)
    rows = {}
    for name, ctl, extra in (
            ("synchronous", BoundedStalenessController(
                8, window_steps=0.0, max_window=0.0), {}),
            ("unbounded-async", BoundedStalenessController(
                8, window_steps=1e6, max_window=1e6),
             dict(quality_slo=float("inf"))),
            ("asl-window(AIMD)", BoundedStalenessController(
                8, window_steps=4.0, max_window=8.0),
             dict(quality_slo=6.0, penalty_per_stale=1.0))):
        sps, mean_st, p99_st = rows[name] = simulate(
            8, [1.0] * 8, controller=ctl, **kw, **extra)
        print(f"  {name:18s} steps/s={sps:6.2f}  staleness "
              f"mean={mean_st:4.1f} p99={p99_st:4.0f}")
    return rows


def live_demo(device=None, steps=12) -> dict:
    """Two trainers on gemma-7b-tiny, one slowed, sharing one window;
    -> {pod: its last loss}."""
    print("\n== live demo: 2 trainers, one slowed, shared window ==")
    cfg = registry.get_tiny("gemma_7b")
    ctl = BoundedStalenessController(2, window_steps=2.0, max_window=4.0)
    results, errors = {}, []

    def worker(pod, slow):
        try:
            with tempfile.TemporaryDirectory() as d:
                t = Trainer(cfg, TrainerConfig(
                    total_steps=steps, ckpt_every=100, ckpt_dir=d,
                    global_batch=4, seq_len=32, seed=pod), device=device)
                params, opt_state, step = t.init_or_restore()
                while step < steps:
                    while not ctl.can_commit(pod):
                        time.sleep(0.005)
                    if slow:
                        time.sleep(0.05)
                    batch = t._device_batch(t.data.batch(step))
                    params, opt_state, _, m = t.step_fn(
                        params, opt_state, step, batch)
                    step += 1
                    ctl.commit(pod)
                results[pod] = float(m["loss"])
        except Exception as e:                   # reported by the caller
            errors.append(e)
            ctl.commit(pod)

    ts = [threading.Thread(target=worker, args=(0, False)),
          threading.Thread(target=worker, args=(1, True))]
    t0 = time.time()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]
    print(f"  both pods finished {steps} steps in {time.time()-t0:.1f}s, "
          f"staleness stayed <= {ctl.window}; losses {results}")
    return results


def main(device=None, steps=12) -> tuple:
    return simulation(), live_demo(device, steps)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    main(device=ap.parse_args().device)
