"""The benchmark's CPU tests: the repository root on the path, so the
``benchmark`` package and the port import as the harness imports them."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
