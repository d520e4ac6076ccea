"""The port's examples (``examples/*_torch.py``) on the CPU at tiny
arguments: ``quickstart_torch`` (train, preempt, restore, finish),
``serve_slo_torch`` (yi-6b-tiny with 32-dimensional heads calibrated,
then fifo, greedy and asl),
``straggler_training_torch`` (its simulation rows equal to the JAX
package's, then the live two-trainer demo on gemma-7b-tiny) and
``serving_bench_torch`` (every section printed, at a short scale).  Each runs the
plain versions of the kernels here (no kernel launches); none imports
``jax``, the JAX package or ``benchmarks``."""

import ast
import importlib.util
import json
from pathlib import Path

import pytest

from repro.dist import staleness as jst

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _launches() -> list:
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    return [f.launches for f in (fa.flash_attention, da.decode_attention,
                                 fb.flash_attention_bwd)]


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_example_imports_nothing_of_jax(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = [a.name for a in node.names] \
            if isinstance(node, ast.Import) else \
            [node.module or ""] if isinstance(node, ast.ImportFrom) else []
        for mod in names:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro",
                                             "benchmarks"), (path, mod)


def test_quickstart_train_preempt_restore_finish(capsys):
    n0 = _launches()
    out = _load("quickstart_torch").main(
        total_steps=6, preempt_at=3, ckpt_every=3, global_batch=2,
        seq_len=16, check_loss=False, device="cpu")
    assert out["step"] == 6 and len(out["history"]) == 3
    assert "quickstart OK" in capsys.readouterr().out
    assert _launches() == n0


def test_serve_slo_prints_three_schedulers(capsys):
    rows = _load("serve_slo_torch").main(device="cpu")
    assert list(rows) == ["fifo", "greedy", "asl"]
    assert all(m["n"] > 0 for m in rows.values())
    out = capsys.readouterr().out
    assert "calibrated on yi-6b-tiny" in out
    assert sum(line.split()[0] in rows for line in out.splitlines()
               if line.strip()) == 3


def test_straggler_simulation_rows_are_the_references_then_live_demo():
    ex = _load("straggler_training_torch")
    rows = ex.simulation()
    kw = dict(straggle_prob=0.1, straggle_factor=5.0, seed=11,
              horizon_steps=300)
    want = {
        "synchronous": jst.simulate(8, [1.0] * 8, controller=(
            jst.BoundedStalenessController(8, window_steps=0.0,
                                           max_window=0.0)), **kw),
        "unbounded-async": jst.simulate(8, [1.0] * 8, controller=(
            jst.BoundedStalenessController(8, window_steps=1e6,
                                           max_window=1e6)),
            quality_slo=float("inf"), **kw),
        "asl-window(AIMD)": jst.simulate(8, [1.0] * 8, controller=(
            jst.BoundedStalenessController(8, window_steps=4.0,
                                           max_window=8.0)),
            quality_slo=6.0, penalty_per_stale=1.0, **kw)}
    assert repr(rows) == repr(want)
    losses = ex.live_demo(device="cpu", steps=3)
    assert sorted(losses) == [0, 1]
    assert all(v == v and v > 0 for v in losses.values())


def test_serving_bench_runs_every_section_at_a_short_scale(capsys,
                                                          monkeypatch):
    ex = _load("serving_bench_torch")
    monkeypatch.setattr(ex, "SCALE", 0.05)
    out = ex.main()
    assert list(out) == list(ex.ALL)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == sum(len(r) for r in out.values()) == 4 + 3 + 30 + 3
    names = [json.loads(line)["name"] for line in lines]
    assert names == [r["name"] for rows in out.values() for r in rows]
    assert names[0] == "db_serving/fifo" and \
        names[-1] == "straggler/asl-staleness"
    assert "dispatch/key-jbsq/load0.90" in names
