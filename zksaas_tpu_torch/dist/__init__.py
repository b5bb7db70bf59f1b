"""Distributed primitives over packed shares (king paths); see the package
docstring in zksaas_tpu_torch/__init__.py."""

from .dpp import PpBlind, d_pp

__all__ = ["PpBlind", "d_pp"]
