"""``examples/lock_microbench_torch.py`` (the port's entry point for the
paper's figures) against ``examples/lock_microbench.py`` (the JAX
package's) at short horizons, on the CPU: each section's printed table,
number for number (the titles may name each package's own means).  The
policy matrix, Figure 1 and Figure 8b here; the key-sharded matrix,
load-latency and open loop in ``test_torch_lock_microbench_load.py``.
Tolerance: exact equality of every printed row."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_EX = _load("lock_microbench")
PORT_EX = _load("lock_microbench_torch")


def check_section(capsys, name: str, **kw) -> list:
    """Run section ``name`` in both examples; -> the port's rows, after
    asserting that every row (each line but the titles) is equal."""
    getattr(JAX_EX, name)(**kw)
    want = capsys.readouterr().out.splitlines()
    getattr(PORT_EX, name)(device="cpu", **kw)
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    rows = [(g, w) for g, w in zip(got, want)
            if g and not g.startswith("==")]
    assert [g for g, _ in rows] == [w for _, w in rows]
    return [g for g, _ in rows]


def test_policy_matrix(capsys):
    rows = check_section(capsys, "policy_matrix", slo_us=100.0,
                         sim_time_us=2000.0)
    assert len(rows) == 1 + 10


def test_figure1(capsys):
    rows = check_section(capsys, "figure1", ns=(1, 5, 8),
                         sim_time_us=3000.0)
    assert len(rows) == 1 + 3


def test_figure8b(capsys):
    rows = check_section(capsys, "figure8b", slos=(20.0, 80.0, 200.0),
                         sim_time_us=3000.0)
    assert len(rows) == 1 + 3


def test_the_example_runs_on_the_card_by_default():
    """Without ``--device`` it asks for the CUDA device, and raises here
    (no card) rather than run on the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "lock_microbench_torch.py")],
        capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert "runs on a CUDA device by default" in res.stderr
