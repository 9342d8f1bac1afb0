"""Built-in engine-invariant lint rules.

Importing this package registers every rule with the framework registry
(:func:`repro_torch.analysis.framework.registered_rules` does it lazily).

Rule catalog:

* ``backend-coverage`` — every ``*Sink`` class declared in ``query/ast.py``
  must be handled (or explicitly rejected) by an ``isinstance`` dispatch in
  *both* ``query/planner.py`` and ``query/execute.py``; new sinks cannot
  silently fall through to a wrong backend.
* ``cache-key-completeness`` — plan/op dataclasses in ``query/ast.py`` must
  be ``frozen=True`` and must not grow non-field attributes; every field
  must flow into the canonical ``_payload`` fingerprint.
* ``lock-discipline`` — attributes mutated under ``with self.<lock>`` (or
  annotated ``# guarded by <lock>``) are lock-protected: mutating them
  outside the lock, blocking calls while holding a lock, and statically
  inverted acquisition orders are findings.
* ``rng-time-hygiene`` — no ambient state (``time.time``, ``datetime.now``,
  ``random``/``np.random``/``torch`` sampling, ``os.environ``) inside the
  kernel wrappers or the fingerprint/plan-key code paths.
"""

from . import backends  # noqa: F401
from . import cache_key  # noqa: F401
from . import hygiene  # noqa: F401
from . import locks  # noqa: F401
