"""Lock factories the copied ``core/`` modules import.

Only ``locks`` is carried over: the reference's ``guards`` names modules of
the JAX package by string and imports them, so it stays there.
"""

from . import locks  # noqa: F401  (re-exported submodule)

__all__ = ["locks"]
