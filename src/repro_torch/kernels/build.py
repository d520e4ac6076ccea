"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into a shared library that :mod:`ctypes` loads — no PyTorch
headers, so a build takes seconds; ``simstep.cu``, whose 31 kernel
instantiations take the longest, is compiled as several libraries, one
per instantiation group (``SIMSTEP_GROUPS``), in parallel.  Libraries go to ``kernels/_build/``
(listed in ``.gitignore``) under a name keyed by a hash of the source,
every shared header ``csrc/*.cuh`` and the flags, so an edited source or
header is rebuilt at its next use and a stale library is never loaded.  Nothing is built when the package is imported:
the first launch builds, or :func:`build` builds every source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("simstep", "mlstm_scan", "flash_attention", "decode_attention",
           "rglru_scan", "flash_attention_bwd")
# -fmad=false: no a*b+c contraction, so f32 results match the reference.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# Sources that encode TMA tensor maps call the driver API.
LIBS = {"flash_attention": ("-lcuda",), "flash_attention_bwd": ("-lcuda",)}
# fused_chunk's instantiation groups, each built from csrc/simstep.cu as a
# library of its own (``-DSIMSTEP_BUILT=<mask>``), all in parallel with the
# other sources.  An instantiation is (policy id, 10 for a merged set;
# stochastic; takes the keyed operands ArgsK), as csrc/simstep.cu's
# launch_args picks it.
SIMSTEP_GROUPS = (
    tuple((p, False, False) for p in range(7)) + ((10, False, False),
                                                  (10, False, True))
    + tuple((p, False, True) for p in (7, 8, 9)),
    tuple((p, True, False) for p in (0, 1, 2, 3)),
    tuple((p, True, False) for p in (4, 5, 6, 10)),
    tuple((p, True, True) for p in (0, 1, 2, 3)),
    tuple((p, True, True) for p in (4, 5, 6)),
    tuple((p, True, True) for p in (7, 8, 9)),
    ((10, True, True),),
)


def _mask(group) -> str:
    return hex(sum(1 << (4 * p + 2 * st + k) for p, st, k in group)) + "ull"


# Sources built as several libraries: name -> each part's extra flags.
PARTS = {"simstep": tuple((f"-DSIMSTEP_BUILT={_mask(g)}",)
                          for g in SIMSTEP_GROUPS)}


def parts(name: str) -> int:
    """How many libraries ``csrc/<name>.cu`` is built as."""
    return len(PARTS.get(name, ((),)))


def flags(name: str, part: int = 0) -> tuple:
    """The nvcc flags of ``csrc/<name>.cu`` (of its library ``part``),
    libraries included."""
    return NVCC_FLAGS + PARTS.get(name, ((),))[part] + LIBS.get(name, ())


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels are built on a machine with the "
                           "CUDA toolkit")
    return path


def lib_path(name: str, part: int = 0) -> Path:
    """Where library ``part`` of ``csrc/<name>.cu`` is (or will be) built:
    keyed by the source, every ``csrc/*.cuh`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags(name, part)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def unit(name: str, part: int) -> str:
    """The name ``build`` reports library ``part`` of a source by:
    ``simstep.3`` for a source built in parts, else the source's."""
    return f"{name}.{part}" if name in PARTS else name


def build(names=SOURCES) -> dict:
    """Compile every library of the named sources that is missing, one
    ``nvcc`` per library, all started together.  Returns :func:`unit`
    name -> compiler output (registers, spills) for the libraries it
    built; raises if any failed."""
    jobs = {}
    for name in names:
        for part in range(parts(name)):
            out = lib_path(name, part)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            nvcc = _nvcc()
            # The driver library to link against: the toolkit's stub (the
            # driver's own libcuda.so.1 is loaded at run time).
            stubs = Path(nvcc).resolve().parent.parent / "lib64" / "stubs"
            link = ["-L", str(stubs)] if LIBS.get(name) and stubs.is_dir() \
                else []
            cmd = [nvcc, *NVCC_FLAGS, *PARTS.get(name, ((),))[part], "-o",
                   str(tmp), str(CSRC / f"{name}.cu"), *link,
                   *LIBS.get(name, ())]
            jobs[unit(name, part)] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True),
                tmp, out, name)
    logs, failed = {}, []
    for key, (proc, tmp, out, name) in jobs.items():
        log, _ = proc.communicate()
        logs[key] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu ({key}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


_LIBS: dict = {}


def load(name: str, part: int = 0) -> ctypes.CDLL:
    """The loaded library ``part`` of ``csrc/<name>.cu``, built first (with
    the source's other parts) if missing."""
    if (name, part) not in _LIBS:
        build((name,))
        _LIBS[name, part] = ctypes.CDLL(str(lib_path(name, part)))
    return _LIBS[name, part]
