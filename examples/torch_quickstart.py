"""Quickstart on the PyTorch port: the paper's pipeline through the query
engine, the program of ``examples/quickstart.py`` on ``repro_torch``.  It
prints the same lines in the same order.

    PYTHONPATH=src python examples/torch_quickstart.py               # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # the host

Every engine of the example (the process-wide default one too) runs on
``--device``: the card by default, with no fallback to the host.
"""

import argparse

import numpy as np

from repro_torch.core import (
    check_columnar,
    discover_dependency_graph,
    filter_dfg,
    paper_example_repo,
    to_dot,
)
from repro_torch.data import ProcessSpec, generate_repository
from repro_torch.device import resolve_device
from repro_torch.query import Q, QueryEngine, default_engine, set_default_engine

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = resolve_device(ap.parse_args().device)
set_default_engine(QueryEngine(device=device))

# --- 1. the paper's worked example (Fig. 3 → Table 1) ----------------------
repo = paper_example_repo()
res = Q.log(repo).dfg()
print("Table 1 (paper worked example):")
print("      " + "  ".join(res.names))
for name, row in zip(res.names, res.value):
    print(f"  {name}  " + "   ".join(str(int(x)) for x in row))

# --- 2. a bigger synthetic log: load → DFG in-store → discover -------------
repo = generate_repository(2_000, ProcessSpec(num_activities=12, seed=4))
assert check_columnar(repo).ok
psi = Q.log(repo).dfg(backend="scatter").value
print(f"\nlog: {repo.num_events} events, {repo.num_traces} traces, "
      f"{int(psi.sum())} directly-follows pairs")

starts, ends = repo.trace_boundaries()
model = discover_dependency_graph(
    filter_dfg(psi, min_count=20), repo.activity_names, starts, ends,
    min_count=20, min_dependency=0.5,
)
print(f"discovered dependency graph: {len(model.edges)} edges")
print(to_dot(model)[:400] + "\n…")

# --- 3. dicing (the paper's Experiment 2 semantics) -------------------------
t0 = float(np.quantile(repo.event_time, 0.25))
t1 = float(np.quantile(repo.event_time, 0.75))
diced = Q.log(repo).window(t0, t1).dfg()
print(f"\ndiced to the middle half of the horizon: "
      f"{int(diced.value.sum())} pairs ({int(psi.sum())} undiced)")

# --- 4. the query engine: plans, pushdowns, and the result cache ------------
print("\nquery plan for the diced query:")
print(Q.log(repo).window(t0, t1).explain())
again = Q.log(repo).window(t0, t1).dfg()
stats = default_engine().stats
print(f"\nre-issued the same query: from_cache={again.from_cache} "
      f"(engine: {stats.queries} queries, {stats.executions} executions, "
      f"{stats.cache_hits} cache hits)")

# --- 5. the event-knowledge-graph tier --------------------------------------
# in auto mode the planner builds the graph once a source crosses the
# measured repeat-query threshold; backend="graph" pins it explicitly
pm = Q.log(repo).process_map(top=0.2).value
print(f"\nprocess map (top 20% nodes/edges): {len(pm.activities)} activities,"
      f" {len(pm.edges)} edges (dropped {pm.dropped_activities} nodes, "
      f"{pm.dropped_edges} edges)")
center = pm.activities[0]
nb = Q.log(repo).neighborhood(center, k=2, direction="both", backend="graph")
print(f"2-hop neighborhood of {center!r}: {len(nb.value.activities)} "
      f"activities via backend={nb.physical.backend} "
      f"(graph store: {default_engine().graphs.stats})")

# --- 6. conformance: replay fitness + optimal alignments --------------------
# how well does the middle half of the horizon conform to the model
# discovered from the whole log?  (sequence semantics: the window re-links)
fit = Q.log(repo).window(t0, t1).fitness(model)
print(f"\nreplay fitness of the diced slice vs the discovered model: "
      f"{fit.value.fitness:.4f} ({fit.value.perfectly_fitting}/"
      f"{fit.value.trace_fitness.shape[0]} traces perfect, "
      f"backend={fit.physical.backend})")
worst = sorted(fit.value.deviating_edges.items(), key=lambda kv: -kv[1])[:3]
print(f"top deviating flows: {worst}")

ali = Q.log(repo).alignments(model)
print(f"optimal alignments (batched per variant, kernels/align_dp): "
      f"mean fitness {ali.value.fitness:.4f}, "
      f"mean cost {float(ali.value.trace_cost.mean()):.2f}, "
      f"cheapest model walk = {ali.value.empty_cost} moves")

# --- 7. observability: traces, metrics, and self-mining forensics -----------
# every result carries a trace of timed spans plus the planner's prediction
tr = again.trace
print(f"\ntrace q{tr.query_id}: backend={tr.executed_backend} "
      f"(planned={tr.planned_backend}) total={tr.total_s * 1e3:.3f}ms "
      f"coverage={tr.coverage() * 100:.1f}%")
print("  spans: " + ", ".join(
    f"{s.name}={s.duration_s * 1e3:.3f}ms" for s in tr.spans))
# explain(after=...) diffs the prediction against what actually ran
print(Q.log(repo).window(t0, t1).explain(after=again))

# the engine's counters/histograms export as dict, JSON lines, or Prometheus
snap = default_engine().metrics_snapshot()
lat = snap["query_latency_seconds{backend=cache,sink=dfg}"]
print(f"\ncache-hit latency: p50={lat['p50'] * 1e6:.0f}us "
      f"p99={lat['p99'] * 1e6:.0f}us over {lat['count']} hits "
      f"(hit ratio {snap['engine_cache_hit_ratio']:.2f})")

# self-mining: the engine's own spans are an event log — mine the miner
own = default_engine().own_telemetry()
forensics = Q.log(own).dfg()
print(f"forensics DFG over {own.num_events} engine events "
      f"({len(forensics.names)} phases): a full scan is the chain "
      f"parse -> cache_probe -> plan -> scan -> sink; hits stop at the probe")

# --- 8. the sharded graph tier: case-partitioned scale-out ------------------
# cases are assigned whole to K shards (case % K), so the global Ψ is a
# pure sum of per-shard counts; each shard keeps its own CSR snapshot,
# fingerprint slot, and delta path
import tempfile

from repro_torch.data import generate_memmap_log
from repro_torch.graph import partition_memmap_log

tmp = tempfile.mkdtemp(prefix="quickstart_shard_")
log = generate_memmap_log(
    f"{tmp}/log", 60_000,
    ProcessSpec(num_activities=12, seed=8, horizon_days=90), seed=8,
)
sharded = partition_memmap_log(log, 4, f"{tmp}/shards")
eng = QueryEngine(device=device)
w0 = float(np.quantile(log.time, 0.25))
w1 = float(np.quantile(log.time, 0.75))
cold = Q.log(sharded).using(eng).window(w0, w1).dfg(backend="sharded-graph")
print(f"\nsharded DFG over K={sharded.num_shards} shards: "
      f"{int(cold.value.sum())} pairs, per-shard branches: "
      f"{[name for name, _ in cold.trace.branches]}")

# appends land on the owning shard only: the re-query extends one shard's
# graph over the 3-row suffix while the other shards' graphs are pure hits
grown = sharded.append(
    np.array([1, 2, 3], dtype=np.int32),       # activities
    np.array([6, 6, 6], dtype=np.int32),       # one case → one owning shard
    log.time[-1] + np.arange(1.0, 4.0),        # appends stay time-ordered
)
rows_before = eng.stats.rows_scanned
warm = Q.log(grown).using(eng).dfg(backend="sharded-graph")
print(f"after a 3-event append: rescanned "
      f"{eng.stats.rows_scanned - rows_before} rows "
      f"(owning shard's suffix only: {eng.graphs.stats.extends} extend, "
      f"{eng.graphs.stats.hits} warm shard hits)")

# --- 9. production serving: admission, coalescing, SLO lanes ----------------
# the transport tier wraps QueryService in an asyncio HTTP layer; here we
# drive its app core in-process (TransportServer serves the same app on a
# socket: POST /query, /query/stream NDJSON, GET /metrics, /stream/*)
import asyncio

from repro_torch.serve import QueryService
from repro_torch.transport import TransportApp, canonical_payload

svc = QueryService(eng)
svc.register("bpi", repo)


async def serve_demo():
    app = TransportApp(svc)
    # 8 identical concurrent dashboard queries coalesce into ONE engine
    # execution; everyone shares the result
    req = {"log": "bpi", "sink": "process_map", "top": 1.0}
    before = eng.stats.executions
    resps = await asyncio.gather(*[app.handle(req) for _ in range(8)])
    fanned = sum(1 for r in resps if r.headers["X-Coalesced"] == "1")
    print(f"\n8 concurrent identical queries -> "
          f"{eng.stats.executions - before} execution(s), "
          f"{fanned} coalesced, lane={resps[0].headers['X-Lane']}")
    assert canonical_payload(resps[0].payload) == canonical_payload(
        svc.query(req)
    )  # the transport path is bit-identical to the direct dict path
    # the live metrics feed already includes the transport's own health
    metrics = (await app.handle({"sink": "metrics"})).payload["metrics"]
    print("transport fanout counter:",
          metrics["transport_coalesce_fanout_total"])
    app.close()


asyncio.run(serve_demo())

# --- 10. distributed observability: traces, exemplars, SLOs, trace store ----
# every request carries one trace id end to end (transport span -> engine
# trace -> per-shard sub-traces), histograms keep exemplar trace ids, the
# SLO engine turns the live metrics into verdicts + burn rates, and the
# persisted trace ring mines like any other event log
import tempfile

from repro_torch.obs import mint_context
from repro_torch.transport import TransportConfig

trace_dir = tempfile.mkdtemp(prefix="quickstart_traces_")
svc2 = QueryService(QueryEngine(device=device))
svc2.register("bpi", repo)


async def obs_demo():
    app = TransportApp(svc2, TransportConfig(trace_dir=trace_dir))
    inbound = mint_context()  # e.g. parsed from an inbound traceparent
    resp = await app.handle(
        {"log": "bpi", "sink": "dfg"},
        traceparent=inbound.to_traceparent(),
    )
    print(f"\none trace id end to end: request={inbound.trace_id}")
    print(f"  response X-Trace-Id={resp.headers['X-Trace-Id']}"
          f"  payload trace_id={resp.payload['trace_id']}")
    await app.handle({"log": "bpi", "sink": "dfg"})  # a cache hit, traced too

    # SLO verdicts + error budgets + burn rates from the live registry
    slo = (await app.handle({"sink": "slo"})).payload
    for o in slo["objectives"]:
        print(f"  slo {o['name']}: ok={o['ok']} "
              f"budget_left={o['error_budget_remaining']}")

    # exemplars: the worst recent trace id per latency bucket, in the
    # Prometheus exposition (OpenMetrics syntax)
    prom = svc2.engine.metrics.to_prometheus()
    print("  exemplar lines:",
          sum(1 for l in prom.splitlines() if "trace_id=" in l))

    # the persisted ring reads back as an event log: mine your own traces
    # with the same Algorithm 1 the engine serves
    own = app.trace_store.to_repository()
    spans_dfg = Q.log(own).dfg()
    print(f"  mined {own.num_traces} persisted trace(s): "
          f"{spans_dfg.names[:4]}…")
    app.close()


asyncio.run(obs_demo())

# the invariants behind all of the above are machine-checked: run
#   python -m repro_torch.analysis                (lint: sinks/keys/locks)
#   REPRO_LOCKDEP=1 pytest tests/test_torch_transport.py  (lock-order sanitizer)
#   python -m repro_torch.analysis --kernel-report PATH   (on the card)
# see the "Static analysis" section of README.md
