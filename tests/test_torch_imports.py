"""The port stands alone: no module under ``src/repro_torch/`` (nor
``chip_smoke.py``) imports ``jax`` or anything of the JAX package
``repro``, and the package imports with both blocked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


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
    return top in ("jax", "jaxlib", "repro")


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for want in ("src/repro_torch/core/simlock.py",
                 "src/repro_torch/kernels/simstep.py",
                 "src/repro_torch/workloads/generators.py",
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
            "assert not any(m.split('.')[0] in ('jax', 'repro') "
            "for m, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
