"""Puts the repository's ``src`` on ``sys.path``, so that each example runs
as ``python examples_torch/<name>.py`` from a checkout without
``PYTHONPATH``."""

import pathlib
import sys

SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)
