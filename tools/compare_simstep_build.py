#!/usr/bin/env python3
"""Compare this tree's CUDA build with another tree's (a parent commit
unpacked with ``git archive``): each tree's whole build timed from
scratch (every ``csrc/*.cu`` as ``kernels/build.py`` builds it, all at
once), then every ``fused_chunk`` kernel's SASS side by side.

    python3 tools/compare_simstep_build.py PARENT_TREE

Needs ``nvcc`` and ``cuobjdump`` (``/usr/local/cuda/bin``); run it on a
machine with the CUDA toolkit.  The SASS is read with ``cuobjdump -sass``
from every library ``simstep.cu`` is built into, with two things that are
not code normalised: the tag of the source's anonymous namespace in the
mangled names (it follows the source's text) and the column padding
(``cuobjdump`` pads to the widest line of a file).  Exits 1 when a kernel
differs or is missing.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
TAG = re.compile(r"_ZN\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")

# Run in each tree: build everything into a fresh directory, timed; print
# the time and the simstep libraries.
_BUILD = """
import json, sys, time
from pathlib import Path
from repro_torch.kernels import build
build.BUILD_DIR = Path(sys.argv[1])
t = time.time()
build.build()
parts = getattr(build, "parts", lambda name: 1)("simstep")
libs = [str(build.lib_path("simstep", p) if parts > 1 else
            build.lib_path("simstep")) for p in range(parts)]
print(json.dumps({"seconds": time.time() - t, "libs": libs}))
"""


def build_tree(tree: Path, out: Path) -> dict:
    res = subprocess.run([sys.executable, "-c", _BUILD, str(out)],
                         cwd=tree, capture_output=True, text=True,
                         env={**os.environ,
                              "PYTHONPATH": str(tree / "src")})
    if res.returncode != 0:
        raise RuntimeError(f"the build of {tree} failed:\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def kernels(libs) -> dict:
    """Kernel name -> its SASS lines, over ``libs``, normalised."""
    out = {}
    for lib in libs:
        text = subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True,
                              text=True, check=True).stdout
        name = None
        for line in text.splitlines():
            line = " ".join(TAG.sub("_ZN_ANON_", line).split())
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1)
                out[name] = []
            elif name:
                out[name].append(line)
    return out


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(argv[0]).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        built = {label: build_tree(tree, Path(tmp) / label)
                 for label, tree in (("other", other), ("this", ROOT))}
        for label, b in built.items():
            print(f"{label} tree: every source built in {b['seconds']:.1f} s,"
                  f" simstep.cu as {len(b['libs'])} libraries", flush=True)
        want = kernels(built["other"]["libs"])
        got = kernels(built["this"]["libs"])
    same = [k for k in want if got.get(k) == want[k]]
    print(f"fused_chunk kernels: {len(want)} in the other tree, {len(got)} "
          f"in this one; SASS identical: {len(same)} of {len(want)}")
    for k in sorted(want):
        n = sum(1 for line in want[k] if re.match(r"/\*[0-9a-f]+\*/", line))
        print(f"  {'same' if k in same else 'DIFFERS'} {k}: {n} "
              f"instructions")
    return 0 if len(same) == len(want) == len(got) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
