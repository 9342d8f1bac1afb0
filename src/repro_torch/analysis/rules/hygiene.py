"""rng-time-hygiene: no ambient state in kernel or fingerprint paths.

Kernels must be pure functions of their operands (bit-identity against the
oracle is the whole correctness story) and fingerprints must be pure
functions of the data they summarize (a cache key that reads the clock or
the environment invalidates — or worse, *fails* to invalidate — on its
own).  This rule bans calls that smuggle ambient state into those paths:
wall/monotonic clocks, RNGs, environment reads.

Scope: ``kernels/*/ops.py`` (each CUDA kernel's wrapper and its plain
version; the kernel bodies are ``.cu`` sources, which an AST rule cannot
read), plus ``query/cache.py`` and ``query/ast.py`` (the two
fingerprint/plan-key modules).  ``kernels/timing.py`` instruments *around*
calls and ``kernels/build.py`` reads ``$CUDA_HOME`` and the clock to find
and time ``nvcc``: both are deliberately out of scope.  The port samples
with torch where the reference sampled with ``jax.random``, so torch's
sampling calls take that prefix's place.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ..framework import Finding, Project, rule

RULE = "rng-time-hygiene"

SCOPE_GLOBS = (
    "kernels/*/ops.py",
    "query/cache.py",
    "query/ast.py",
)

BANNED_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
    "os.getenv", "os.environ.get", "os.urandom",
    "uuid.uuid1", "uuid.uuid4",
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
    "torch.normal", "torch.bernoulli", "torch.multinomial",
    "torch.poisson", "torch.seed", "torch.initial_seed",
}
BANNED_PREFIXES = (
    "random.", "np.random.", "numpy.random.", "torch.random.", "secrets.",
)


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@rule(
    RULE,
    "no clocks, RNGs, or environment reads inside kernel bodies or the "
    "fingerprint/plan-key code paths",
)
def check_hygiene(project: Project):
    for glob in SCOPE_GLOBS:
        for path in project.iter_pkg(glob):
            tree = project.tree(path)
            rel_in_pkg = path.relative_to(project.pkg_root).as_posix()
            for node in ast.walk(tree):
                banned = None
                if isinstance(node, ast.Call):
                    dotted = _dotted(node.func)
                    if dotted is not None and (
                        dotted in BANNED_CALLS
                        or dotted.startswith(BANNED_PREFIXES)
                    ):
                        banned = f"call to {dotted}()"
                elif isinstance(node, ast.Subscript):
                    if _dotted(node.value) == "os.environ":
                        banned = "os.environ[...] read"
                if banned is not None:
                    yield Finding(
                        RULE, project.rel(path), node.lineno,
                        f"{banned} in {rel_in_pkg} — ambient state is "
                        "banned in kernel and fingerprint code paths",
                    )
