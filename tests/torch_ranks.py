"""Rank launcher for the port's multi-process tests: starts ``world`` gloo
ranks on the CPU with the ``spawn`` start method, each counting its shard of
one seeded pair set through :mod:`repro_torch.core.distributed` and the
engine's ``distributed`` backend, and saves each rank's answers under
``out_dir``.

    python tests/torch_ranks.py OUT_DIR WORLD AXIS_SHAPE AXIS_NAMES

e.g. ``python tests/torch_ranks.py /tmp/x 4 2,2 pod,data``.  Rendezvous is a
``file://`` path inside ``OUT_DIR``; every rank destroys its process group
before it exits, and the launcher exits non-zero when any rank fails or
outlives its time limit.  Tests run this script in a child process, so the
test process itself never holds a process group, changes its environment or
sets a start method.
"""

import datetime
import json
import multiprocessing
import os
import sys

#: seconds a rank may take (import, rendezvous, counts, reductions)
RANK_TIMEOUT_S = 60
#: the seeded input every rank sees
PAIRS, ACTIVITIES, SHARDS = 5_001, 11, 5


def inputs():
    import numpy as np

    rng = np.random.default_rng(7)
    src = rng.integers(0, ACTIVITIES, PAIRS).astype(np.int32)
    dst = rng.integers(0, ACTIVITIES, PAIRS).astype(np.int32)
    valid = rng.random(PAIRS) < 0.8
    # shard Ψ over shard-local vocabularies (a prefix of the union's each)
    psis, maps = [], []
    for k in range(SHARDS):
        a = ACTIVITIES - k
        psis.append(rng.integers(0, 50, (a, a)).astype(np.int64))
        maps.append(np.arange(a))
    return src, dst, valid, psis, maps


def rank_main(rank, world, shape, names, out_dir):
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.core import distributed as D
    from repro_torch.core.compat import make_mesh
    from repro_torch.core.repository import EventRepository
    from repro_torch.query import Q, QueryEngine

    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'rendezvous')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S),
    )
    try:
        mesh = make_mesh(shape, names, devices=["cpu"] * world)
        src, dst, valid, psis, maps = inputs()
        out, records = {}, {}
        for hier in (True, False):
            key = "hierarchical" if hier else "flat"
            out[key] = D.distributed_dfg(
                mesh, src, dst, valid, ACTIVITIES, hierarchical=hier
            )
            records[key] = [
                [c.op, list(c.axes), c.group_size, list(c.shape), c.dtype]
                for c in D.last_reductions
            ]
        out["merged"] = D.merge_shard_psis(psis, maps, ACTIVITIES, mesh=mesh)
        records["merged"] = [list(c.axes) for c in D.last_reductions]
        # the engine's distributed backend over a one-trace repository of
        # the activities ``src``
        repo = EventRepository(
            event_activity=src,
            event_trace=np.zeros(PAIRS, np.int32),
            event_time=np.arange(PAIRS, dtype=np.float64),
            trace_log=np.zeros(1, np.int32),
            activity_names=[f"a{i:02d}" for i in range(ACTIVITIES)],
            trace_names=["t0"],
            log_names=["log"],
        )
        res = Q.log(repo).using(QueryEngine(device="cpu", mesh=mesh)).dfg()
        out["engine"] = res.value
        records["engine_backend"] = res.physical.backend
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(records, f)
    finally:
        dist.destroy_process_group()


def main(argv):
    out_dir, world = argv[0], int(argv[1])
    shape = tuple(int(s) for s in argv[2].split(","))
    names = tuple(argv[3].split(","))
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=rank_main, args=(r, world, shape, names, out_dir))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    codes = []
    for p in procs:
        p.join(RANK_TIMEOUT_S)
        if p.is_alive():
            p.kill()
            p.join()
        codes.append(p.exitcode)
    print(json.dumps({"exitcodes": codes}))
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
