"""The check that a run loaded neither JAX nor the JAX package.

Names are compared by their top-level part, whole: the port's package
name begins with the JAX package's, so a prefix test would flag it."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "trajoptmpcreference_tpu")


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    names = sys.modules if names is None else names
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(tops & set(FORBIDDEN))
