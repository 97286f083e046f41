"""Puts the checkout and ``benchmark/`` on ``sys.path`` for the tests of
the harness (run them with ``python -m pytest benchmark/tests``)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
