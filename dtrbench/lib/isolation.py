"""The check that nothing the run loaded is JAX or the JAX package.

Names are compared by their top level, the part before the first dot, as
whole words: ``repro_torch`` (the port) is not ``repro`` (the JAX
package)."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "repro"))


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
