"""Host-side analysis modules, copied from the reference.

``locks`` holds the lock factories that the copied ``core/`` and
``serving/`` modules import; ``guards`` is the guarded-state registry (which
lock guards which attribute of the port's serving classes and plan cache);
``astlint`` the AST rules over the port's ``core/``, ``comm/`` and
``serving/``; ``planlint``, the workload-independent plan verifier, is what
``serving/server.py`` imports to audit its cache; ``corpus`` the golden plan
corpus.  ``python -m repro_torch.analysis --all`` runs the lint and the plan
verifier and exits nonzero on any finding.

This ``__init__`` imports the dependency-free runtime modules alone
(``locks`` and ``guards``, as the reference's): ``core`` and ``serving``
import the lock factories from here, so pulling in ``planlint`` (which
imports ``core.plan``) at package import time would be a cycle.
"""

from . import guards, locks  # noqa: F401  (re-exported submodules)

__all__ = ["locks", "guards"]
