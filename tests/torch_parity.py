"""Shared helpers for the parity tests of the PyTorch port (``repro_torch``)
against the JAX reference package (``repro``)."""

import collections
import os
import re

import repro.core.variants as ref_variants
import repro.query as ref_query
from repro.core.repository import EventRepository as RefRepository

#: the reference's backend names that the port renames (reference → port);
#: every other backend name is shared
_PORT_NAME = {"pallas": "kernel"}
_REF_NAME = {port: ref for ref, port in _PORT_NAME.items()}


def port_backend(ref_name: str) -> str:
    """The port's name for a reference backend (``pallas`` → ``kernel``)."""
    return _PORT_NAME.get(ref_name, ref_name)


def ref_backend(port_name: str) -> str:
    """The reference's name for a port backend (``kernel`` → ``pallas``)."""
    return _REF_NAME.get(port_name, port_name)


def port_notes(ref_notes):
    """A reference plan's notes with each ``branch[<name>]=<backend>`` note
    naming the port's backend."""
    return tuple(
        re.sub(
            r"^(branch\[.*\]=)(.*)$",
            lambda m: m.group(1) + port_backend(m.group(2)),
            n,
        )
        for n in ref_notes
    )


def ref_repository(repo) -> RefRepository:
    """The reference's repository of the same columns and names as the
    port's ``repo``."""
    return RefRepository(
        event_activity=repo.event_activity.copy(),
        event_trace=repo.event_trace.copy(),
        event_time=repo.event_time.copy(),
        trace_log=repo.trace_log.copy(),
        activity_names=list(repo.activity_names),
        trace_names=list(repo.trace_names),
        log_names=list(repo.log_names),
    )


def exact_variants(repo) -> collections.Counter:
    """Traces grouped by the tuple of their activity ids, with no hash."""
    seqs = collections.defaultdict(list)
    for t, a in zip(repo.event_trace.tolist(), repo.event_activity.tolist()):
        seqs[t].append(a)
    return collections.Counter(tuple(s) for s in seqs.values())


def collides(repo) -> bool:
    """True when the reference's rolling hash merges two distinct activity
    sequences of the port's ``repo`` into one variant (the port splits
    them, so the two packages' variant tables differ there)."""
    ref = ref_variants.trace_variants(ref_repository(repo))
    return ref.num_variants != len(exact_variants(repo))


def assert_no_collision(*repos) -> None:
    """None of the port's repositories holds a reference hash collision —
    what a parity test of variant tables, ``top_variants`` or alignments
    asserts of each log (and selection) it hands both packages."""
    for r in repos:
        assert not collides(r)


def ref_engine(**kw):
    """A reference ``QueryEngine`` that plans on the static thresholds the
    port's default CPU engine uses: the reference would otherwise read the
    crossovers (and crossover curves) of its committed ``BENCH_*.json``
    records, measured on other hardware, which the port never reads."""
    kw.setdefault("calibration_path", os.devnull)
    kw.setdefault("graph_crossover", 3)
    kw.setdefault("replay_crossover", 1 << 22)
    kw.setdefault("sharded_crossover", 1 << 18)
    eng = ref_query.QueryEngine(**kw)
    eng.calibration_curves = {}
    return eng
