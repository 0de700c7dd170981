"""The check that no JAX is loaded: top-level module names, compared whole
(the port's name, `insr_pde_tpu_torch`, begins with the JAX package's)."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "insr_pde_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among `names` (default: the modules
    this process has loaded)."""
    names = sys.modules if names is None else names
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(tops & set(FORBIDDEN))
