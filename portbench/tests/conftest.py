"""The benchmark's tests import ``portbench`` and the program from the
checkout's root, however pytest is started."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
