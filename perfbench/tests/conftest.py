"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
root of the checkout. Tests that need the card carry the repo's ``cuda``
marker and skip without one."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
