"""What a run of the benchmark may not have loaded.

Module names are compared by their top-level name (the part before the
first dot) as a whole: zksaas_tpu_torch, the program under test, begins
with zksaas_tpu, the JAX package it was ported from, and is not it.
"""

from __future__ import annotations

# JAX and the JAX package: never in the process that prints a result
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "zksaas_tpu"})


def top_level(names) -> set[str]:
    return {n.split(".", 1)[0] for n in names}


def forbidden_modules(modules, forbidden=FORBIDDEN) -> set[str]:
    """The forbidden top-level names among the loaded modules' names."""
    return top_level(modules) & set(forbidden)
