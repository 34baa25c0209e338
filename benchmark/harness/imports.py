"""The modules a run may not hold: JAX, its libraries and the JAX
package, compared by whole top-level name (the port's package name
begins with the JAX package's, so a prefix test would be wrong)."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "rac2d_tpu")


def top_level(name):
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None):
    """The forbidden top-level names among the loaded modules' names."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & set(FORBIDDEN))
