#!/usr/bin/env python3
"""Run one ``chip_smoke.py`` phase from two checkouts in turns on one CUDA
card: A, B, B, A, each in a process of its own.

    python3 tools/chip_phase_ab.py DIR_A DIR_B PHASE [PHASE ...]

DIR_A and DIR_B are checkouts of the repo (for example ``git archive`` s of
two commits unpacked under ``build/``); each PHASE is the name of a
zero-argument function of their ``chip_smoke.py`` (``phase_deployment``,
``phase_prefill_32k``, ``phase_serve_engine``, ...).  Each process builds
what the phase needs in its own checkout, runs the phases, and prints their
JSON records; this script prints every record with the turn and the
checkout it came from.  Exits non-zero if a run fails.
"""

import json
import subprocess
import sys
from pathlib import Path

RUNNER = """
import sys
sys.path[:0] = ['.', 'src']
import torch
import chip_smoke
torch.backends.cuda.matmul.allow_tf32 = False
for name in sys.argv[1:]:
    getattr(chip_smoke, name)()
"""


def main() -> int:
    if len(sys.argv) < 4:
        print(__doc__, file=sys.stderr)
        return 2
    a, b, phases = Path(sys.argv[1]), Path(sys.argv[2]), sys.argv[3:]
    for turn, (label, root) in enumerate((("A", a), ("B", b), ("B", b), ("A", a)), 1):
        out = subprocess.run([sys.executable, "-c", RUNNER, *phases], cwd=root,
                             capture_output=True, text=True)
        if out.returncode:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            print(f"turn {turn} ({label}, {root}) failed: rc {out.returncode}", file=sys.stderr)
            return 1
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({"turn": turn, "side": label, "checkout": str(root),
                                  **json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
