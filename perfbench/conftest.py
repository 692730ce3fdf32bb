"""The benchmark's tests drive the port on the CPU: its package is under
``src`` at the root of the checkout."""
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)
