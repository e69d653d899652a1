"""Host-side analysis modules copied from the reference.

``locks`` holds the lock factories that the copied ``core/`` and
``serving/`` modules import; ``planlint``, the workload-independent plan
verifier, is what ``serving/server.py`` imports to audit its cache.  The
reference's ``guards`` is not copied: it names modules of the JAX package
by string and imports them.

This ``__init__`` imports ``locks`` alone: ``core`` and ``serving`` import
the lock factories from here, so pulling in ``planlint`` (which imports
``core.plan``) at package import time would be a cycle.
"""

from . import locks  # noqa: F401  (re-exported submodule)

__all__ = ["locks"]
