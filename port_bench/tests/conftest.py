"""The benchmark's tests: ``python -m pytest port_bench/tests -q`` from the root of
the repository (the card's test with ``-m cuda`` on a machine with an NVIDIA GPU)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
