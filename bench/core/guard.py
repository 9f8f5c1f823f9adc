"""The modules a run of the port may not load."""

from __future__ import annotations

import sys
from typing import List

#: top-level module names of JAX and of the JAX package the port mirrors
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """The forbidden top-level names in ``sys.modules``, each compared whole
    (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)
