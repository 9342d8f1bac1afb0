"""``repro_torch.analysis`` — engine-invariant static analysis and runtime
sanitizers for the port's tree.

Three layers keep the engine's correctness contracts machine-checked:

* the AST lint (:mod:`.framework` + :mod:`.rules`) — backend coverage,
  cache-key completeness, lock discipline, RNG/time hygiene — run as
  ``python -m repro_torch.analysis`` (it gates on ``--fail-on-new`` against
  the committed ``analysis_torch_baseline.json``);
* the Hopper launch checker (:mod:`.kernels_check`) — each CUDA launch's
  grid, block and shared memory with nvcc's ptxas resources against the
  H100's limits, and the resident blocks per SM;
* the runtime lock-order sanitizer (:mod:`.lockdep`) — under
  ``REPRO_LOCKDEP=1`` every engine lock records acquisition order and
  inversions fail fast.

This module keeps imports lazy: :mod:`.lockdep` is stdlib-only so the
engine (which imports it at module load) never pulls the lint framework
in.
"""

from .lockdep import LockOrderError, make_lock  # stdlib-only, engine-facing

__all__ = [
    "LockOrderError",
    "make_lock",
    "Finding",
    "Project",
    "run_rules",
    "KernelLaunchError",
    "check_launch",
]


def __getattr__(name):  # lazy: the lint stack is CLI/test-facing
    if name in ("Finding", "Project", "run_rules"):
        from . import framework

        return getattr(framework, name)
    if name in ("KernelLaunchError", "check_launch"):
        from . import kernels_check

        return getattr(kernels_check, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
