"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into a shared library that :mod:`ctypes` loads — no PyTorch
headers, so a build takes seconds.  Libraries go to ``kernels/_build/``
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


def flags(name: str) -> tuple:
    """The nvcc flags of ``csrc/<name>.cu``, libraries included."""
    return NVCC_FLAGS + LIBS.get(name, ())


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels are built on a machine with the "
                           "CUDA toolkit")
    return path


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built: keyed
    by the source, every ``csrc/*.cuh`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns name -> compiler output
    (registers, spills) for the sources it built; raises if any failed."""
    jobs = {}
    for name in names:
        out = lib_path(name)
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
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
               *link, *LIBS.get(name, ())]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


_LIBS: dict = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    if name not in _LIBS:
        build((name,))
        _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return _LIBS[name]
