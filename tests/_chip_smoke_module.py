"""``chip_smoke.py`` loaded as a module, for tests that hold the port to
its constants (its own imports are the standard library's)."""

from __future__ import annotations

import importlib.util
from pathlib import Path


def chip_smoke():
    """``chip_smoke.py`` at the repo's root, as a module."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
