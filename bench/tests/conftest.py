"""The harness's modules import as ``harness.*`` and ``reference.*`` (the
``bench/`` folder on the path, as ``bench/run.py`` puts it) and the program
from ``src/``."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
