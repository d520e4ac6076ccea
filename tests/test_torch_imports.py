"""The port stands alone: no module under ``src/repro_torch/`` (nor
``chip_smoke.py``, nor ``examples/lock_microbench_torch.py``) imports
``jax``, anything of the JAX package ``repro`` or the JAX harness
``benchmarks``, and the package and the example run with all three
blocked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "lock_microbench_torch.py"
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", EXAMPLE]


def _imported_modules(path: Path) -> list:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "benchmarks")


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES
             + sorted((ROOT / "src" / "repro_torch").rglob("*.cu"))}
    for want in ("src/repro_torch/core/simlock.py",
                 "src/repro_torch/kernels/simstep.py",
                 "src/repro_torch/workloads/generators.py",
                 "src/repro_torch/kernels/mlstm_scan.py",
                 "src/repro_torch/models/xlstm.py",
                 "src/repro_torch/models/lm.py",
                 "src/repro_torch/serving/engine.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/configs/yi_6b.py",
                 "src/repro_torch/kernels/flash_attention.py",
                 "src/repro_torch/kernels/decode_attention.py",
                 "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "src/repro_torch/kernels/csrc/decode_attention.cu",
                 "src/repro_torch/configs/recurrentgemma_2b.py",
                 "src/repro_torch/models/rglru.py",
                 "src/repro_torch/kernels/rglru_scan.py",
                 "src/repro_torch/kernels/csrc/rglru_scan.cu",
                 "src/repro_torch/kernels/flash_attention_bwd.py",
                 "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                 "src/repro_torch/tree.py",
                 "src/repro_torch/optim/adamw.py",
                 "src/repro_torch/train/step.py",
                 "src/repro_torch/train/trainer.py",
                 "src/repro_torch/core/locks.py",
                 "src/repro_torch/core/reorderable.py",
                 "src/repro_torch/core/libasl.py",
                 "src/repro_torch/data/pipeline.py",
                 "src/repro_torch/dist/staleness.py",
                 "src/repro_torch/ckpt/checkpointer.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/core/policies/edf.py",
                 "src/repro_torch/core/policies/shfl.py",
                 "src/repro_torch/core/policies/dvfs_race.py",
                 "src/repro_torch/core/energy.py",
                 "src/repro_torch/core/xla_math.py",
                 "src/repro_torch/faults/model.py",
                 "src/repro_torch/dist/sharding.py",
                 "src/repro_torch/workloads/clients.py",
                 "examples/lock_microbench_torch.py",
                 "chip_smoke.py"):
        assert want in names


def test_no_port_module_imports_jax_or_repro():
    bad = {p.relative_to(ROOT).as_posix(): m for p in PORT_FILES
           for m in _imported_modules(p) if _forbidden(m)}
    assert bad == {}


def test_port_imports_with_jax_and_repro_blocked():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import repro_torch, repro_torch.core.simlock as sl\n"
            "import repro_torch.kernels.simstep, repro_torch.kernels.build\n"
            "st, _ = sl.sweep(sl.SimConfig(policy='libasl', "
            "sim_time_us=200.0), {'n_cores': [2, 8]}, device='cpu')\n"
            "assert int(st.events.min()) > 0\n"
            "from repro_torch.core import energy\n"
            "import repro_torch.core.policies.edf, "
            "repro_torch.core.policies.shfl\n"
            "import repro_torch.core.policies.dvfs_race\n"
            "st, _ = sl.sweep(sl.SimConfig(sim_time_us=200.0, "
            "long_epoch_prob=0.5, wakeup_us=1.0, "
            "**energy.amp_power((1,) * 4 + (0,) * 4)), {'policy': ['edf', "
            "'shfl', 'dvfs_race']}, device='cpu')\n"
            "assert int(st.events.min()) > 0 and bool((st.energy > 0).all())\n"
            "import repro_torch.core.xla_math, repro_torch.faults.model\n"
            "st, _ = sl.sweep(sl.SimConfig(sim_time_us=200.0, wl_open=True, "
            "wl_service='lognormal', hist=True, hist_warmup=0, "
            "preempt_rate=0.1, churn_rate=0.1, straggle_rate=0.1), "
            "{'policy': ['fifo', 'libasl']}, device='cpu')\n"
            "assert int(st.events.min()) > 0 and int(st.ep_hist.sum()) > 0\n"
            "import torch\n"
            "import repro_torch.kernels.mlstm_scan, repro_torch.kernels.ops\n"
            "import repro_torch.core.asl_schedule\n"
            "import repro_torch.workloads.traces\n"
            "import repro_torch.serving.engine, repro_torch.launch.serve\n"
            "from repro_torch.configs import registry\n"
            "from repro_torch.models import lm\n"
            "cfg = registry.get_tiny('xlstm-125m')\n"
            "p = lm.init_params(cfg, 0, device='cpu')\n"
            "logits, cache = lm.prefill(p, cfg, {'tokens': torch.ones("
            "(2, 5), dtype=torch.long)}, lm.init_cache(cfg, 2, 8, 'cpu'))\n"
            "assert logits.shape == (2, 1, cfg.vocab)\n"
            "assert bool(torch.isfinite(logits).all())\n"
            "import repro_torch.kernels.flash_attention\n"
            "import repro_torch.kernels.decode_attention\n"
            "import repro_torch.configs.yi_6b\n"
            "cfg = registry.get_tiny('yi-6b')\n"
            "p = lm.init_params(cfg, 0, device='cpu')\n"
            "logits, cache = lm.prefill(p, cfg, {'tokens': torch.ones("
            "(2, 5), dtype=torch.long)}, lm.init_cache(cfg, 2, 8, 'cpu'))\n"
            "assert logits.shape == (2, 1, cfg.vocab)\n"
            "assert bool(torch.isfinite(logits).all())\n"
            "import repro_torch.kernels.rglru_scan, repro_torch.models.rglru\n"
            "import repro_torch.configs.recurrentgemma_2b\n"
            "cfg = registry.get_tiny('recurrentgemma-2b')\n"
            "p = lm.init_params(cfg, 0, device='cpu')\n"
            "logits, cache = lm.prefill(p, cfg, {'tokens': torch.ones("
            "(2, 5), dtype=torch.long)}, lm.init_cache(cfg, 2, 8, 'cpu'))\n"
            "logits, cache, _ = lm.decode_step(p, cfg, torch.ones("
            "(2, 1), dtype=torch.long), torch.full((2,), 5), cache)\n"
            "assert logits.shape == (2, 1, cfg.vocab)\n"
            "assert bool(torch.isfinite(logits).all())\n"
            "import shutil, tempfile\n"
            "import repro_torch.kernels.flash_attention_bwd\n"
            "import repro_torch.optim.adamw, repro_torch.train.step\n"
            "import repro_torch.core.locks, repro_torch.core.reorderable\n"
            "import repro_torch.core.libasl, repro_torch.data.pipeline\n"
            "import repro_torch.dist.staleness, repro_torch.ckpt.checkpointer\n"
            "import repro_torch.train.trainer, repro_torch.tree\n"
            "from repro_torch.launch import train\n"
            "d = tempfile.mkdtemp()\n"
            "out = train.main(['--arch', 'recurrentgemma-2b', '--tiny', "
            "'--steps', '2', '--global-batch', '2', '--seq-len', '8', "
            "'--ckpt-dir', d], device='cpu')\n"
            "shutil.rmtree(d)\n"
            "assert out['step'] == 2\n"
            "assert not any(m.split('.')[0] in ('jax', 'repro') "
            "for m, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_example_imports_no_jax_repro_or_benchmarks():
    mods = _imported_modules(EXAMPLE)
    assert "repro_torch.core" in mods
    assert [m for m in mods if _forbidden(m)] == []


def test_example_runs_with_jax_repro_and_benchmarks_blocked():
    """The example's sections and the port's new modules (clients, npz
    traces, the split and resumable sweeps) run with ``jax``, ``repro``
    and ``benchmarks`` unimportable."""
    code = ("import sys, tempfile\n"
            "for name in ('jax', 'jaxlib', 'repro', 'benchmarks'):\n"
            "    sys.modules[name] = None\n"
            f"sys.path.insert(0, {str(EXAMPLE.parent)!r})\n"
            "import lock_microbench_torch as ex\n"
            "ex.figure8b(slos=(40.0, 200.0), sim_time_us=300.0, "
            "device='cpu')\n"
            "ex.openloop(fracs=(0.4,), sim_time_us=300.0, device='cpu')\n"
            "from repro_torch.core import simlock as sl\n"
            "from repro_torch.dist.sharding import row_splits\n"
            "from repro_torch.workloads import ClientClass, WorkloadMix\n"
            "from repro_torch.workloads import clients, traces\n"
            "m = WorkloadMix((ClientClass('a', slo=50.0, affinity='big'), "
            "ClientClass('b', slo=500.0)))\n"
            "cfg, _ = clients.amp_config(sl.SimConfig(policy='libasl', "
            "sim_time_us=200.0), m, 50.0)\n"
            "d = tempfile.mkdtemp()\n"
            "st, _ = sl.sweep(cfg, {'seed': [0, 1, 2]}, slo_us=50.0, "
            "device='cpu', resume_dir=d, resume_chunk=2)\n"
            "sp, _ = sl.sweep(cfg, {'seed': [0, 1, 2]}, slo_us=50.0, "
            "devices=['cpu'] * 2)\n"
            "assert bool((st.events == sp.events).all())\n"
            "assert row_splits(4, 2) == [2, 2]\n"
            "tr = traces.generate(traces.ArrivalSpec('poisson', 5.0), None, "
            "4.0, 1, classes=m)\n"
            "back = traces.load(traces.save(d + '/t.npz', tr))\n"
            "assert back.classes == ('a', 'b')\n"
            "assert not any(m.split('.')[0] in ('jax', 'repro', "
            "'benchmarks') for m, v in sys.modules.items() "
            "if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "Figure 8b" in res.stdout and "Open-loop" in res.stdout


def test_no_library_attention_or_compiler_in_the_port():
    """The port's attention is its own kernels: no file under
    ``src/repro_torch/`` names PyTorch's fused attention or its
    compiler."""
    words = ("scaled_dot_product_attention", "torch.compile")
    files = sorted(p for p in (ROOT / "src" / "repro_torch").rglob("*")
                   if p.suffix in (".py", ".cu", ".cuh"))
    assert len(files) > 30
    bad = {p.relative_to(ROOT).as_posix(): w for p in files
           for w in words if w in p.read_text()}
    assert bad == {}
