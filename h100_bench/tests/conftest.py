"""The benchmark's tests import it from the repository's root:
``python -m pytest h100_bench/tests``."""

import pathlib
import sys

ROOT = str(pathlib.Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
