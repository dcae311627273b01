"""The benchmark's own tests run from the repository root on the CPU:
``python -m pytest regbench/tests``. The program (``src/``) and the
benchmark's package are put on the path here."""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

torch.set_num_threads(4)
