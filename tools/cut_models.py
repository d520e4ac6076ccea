#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s attention-shape and cut-model phases alone, on
the card, for a quick check of the models cut in depth:

    PYTHONPATH=src python3 tools/cut_models.py [--frontends]

Builds the two attention kernels, then runs phase 13b's kernel checks at
gemma-7b's shapes and phases 13e-13h (``chip_smoke.phase_cut_models``:
each of ``CUT_MODELS``' attention shapes, the model cut in depth kernel
path against plain path, and its serving calibration).  With
``--frontends`` it runs phases 13i and 13j instead (llava-next-mistral-7b
and hubert-xlarge at full config, and ``flash_attention`` at head dim
80).  Prints the Python, PyTorch and CUDA versions, the card
(``nvidia-smi``'s name and power limit), each phase's lines, the phases'
wall times and, last, one JSON line of the kernel timings at each
model's shapes.  Exits non-zero when a phase fails.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    frontends = "--frontends" in (sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("cut_models: no CUDA device", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    print(cs.card_line(), flush=True)
    t0 = time.time()
    build.build(("flash_attention", "decode_attention"))
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    laps = cs.Laps()
    if frontends:
        llava = cs.phase_llava(fa, da)
        laps.lap(f"13i {cs.LLAVA}")
        hubert = cs.phase_hubert(fa, fb, da)
        laps.lap(f"13j {cs.HUBERT}")
        print(laps.line(), flush=True)
        print(json.dumps({cs.LLAVA: llava, cs.HUBERT: hubert}))
        return 0
    cs.phase_gemma_kernels(fa, da)
    laps.lap("13b gemma-7b shapes")
    out = cs.phase_cut_models(fa, da, laps)
    print(laps.line(), flush=True)
    print(json.dumps({arch: dict(shapes, group=group, launches=launches)
                      for arch, (shapes, launches, group) in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
