"""Serve a real (tiny) model under load with SLO-guided admission, on the
PyTorch/CUDA port.

    PYTHONPATH=src python examples/serve_slo_torch.py
    PYTHONPATH=src python examples/serve_slo_torch.py --device cpu

The port's counterpart of ``examples/serve_slo.py``: calibrates the
engine's cost model from *measured* prefill and decode steps of
yi-6b-tiny with 32-dimensional heads (``configs.yi_6b.tiny_card``) on the
device, then drives identical Poisson workloads through FIFO / greedy /
ASL admission and prints the throughput-vs-TTFT trade: the paper's
Figure 2 usage model end to end.  ``--device`` defaults to the CUDA
device (raises without one); ``cpu`` runs the plain PyTorch versions of
the kernels.

The load is the reference's: half the prefill capacity, sized by the
prefill chunk alone.  A model this small is bound by its launches on the
card, where a decode step costs about as much as a prefill chunk, so the
decode steps between the chunks overload the engine and every scheduler
misses the SLO there.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.yi_6b import tiny_card           # noqa: E402
from repro_torch.launch.serve import calibrated_cost       # noqa: E402
from repro_torch.serving.engine import (ServingEngine,     # noqa: E402
                                        poisson_workload)


def main(device=None) -> dict:
    """-> {scheduler: the engine's metrics}."""
    cfg = tiny_card()
    cost = calibrated_cost(cfg, batch=4, prefill_chunk=128, t_cache=256,
                           device=device)
    print(f"calibrated on {cfg.name}: decode={cost.decode_step_s*1e3:.2f}ms"
          f"  prefill_chunk={cost.prefill_chunk_s*1e3:.2f}ms")

    # Target ~50% prefill utilization: rate * avg_chunks * chunk_cost = 0.5
    avg_chunks = (256 + 512 + 1024) / 3 / cost.prefill_chunk
    rate = 0.5 / (avg_chunks * cost.prefill_chunk_s)
    slo = 14 * cost.prefill_chunk_s
    print(f"workload: poisson {rate:.1f} rps, TTFT SLO {slo*1e3:.0f}ms")
    print(f"{'sched':>8} {'n':>5} {'tok/s':>8} {'ttft_p99':>9} "
          f"{'itl_p99':>8} {'viol':>6}")
    out = {}
    for sched in ("fifo", "greedy", "asl"):
        kw = {"default_window": slo / 10, "max_window": 50 * slo} \
            if sched == "asl" else {}
        eng = ServingEngine(sched, cost, scheduler_kwargs=kw, seed=0)
        poisson_workload(eng, rate_rps=rate, duration_s=600 * slo,
                         prompt_lens=[256, 512, 1024],
                         new_tokens=[16, 64], slo_ttft=slo, seed=1)
        m = out[sched] = eng.metrics()
        print(f"{sched:>8} {m['n']:>5} {m['throughput_tok_s']:>8.0f} "
              f"{m['ttft_p99']*1e3:>8.0f}m {m['itl_p99']*1e3:>7.1f}m "
              f"{m['slo_violation_rate']:>6.1%}")
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    main(device=ap.parse_args().device)
