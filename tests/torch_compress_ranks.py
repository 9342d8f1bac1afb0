"""Rank launcher for the port's quantized all-reduce test: starts ``world``
gloo ranks on the CPU with the ``spawn`` start method; rank r reduces the
seeded gradient ``gradient(r)`` with
:func:`repro_torch.train.compressed_psum` and saves the result under
``out_dir``.

    python tests/torch_compress_ranks.py OUT_DIR WORLD

Rendezvous is a ``file://`` path inside ``OUT_DIR``; every rank destroys
its process group before it exits, and the launcher exits non-zero when
any rank fails or outlives its time limit.  Tests run this script in a
child process, so the test process itself never holds a process group,
changes its environment or sets a start method.
"""

import datetime
import multiprocessing
import os
import sys

#: seconds a rank may take (import, rendezvous, the two all-reduces)
RANK_TIMEOUT_S = 60
SHAPE = (33, 7)


def gradient(rank):
    """Rank ``rank``'s seeded f32 gradient, of a scale that differs by
    rank (so the common scale is not every rank's own)."""
    import numpy as np

    rng = np.random.default_rng(100 + rank)
    return (rng.normal(size=SHAPE) * (1.0 + 3 * rank)).astype(np.float32)


def rank_main(rank, world, out_dir):
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.train import compressed_psum

    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'rendezvous')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S),
    )
    try:
        out = compressed_psum(torch.from_numpy(gradient(rank)))
        np.save(os.path.join(out_dir, f"rank{rank}.npy"), out.numpy())
    finally:
        dist.destroy_process_group()


def main(argv):
    out_dir, world = argv[0], int(argv[1])
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    codes = []
    for p in procs:
        p.join(RANK_TIMEOUT_S)
        if p.is_alive():
            p.kill()
            p.join()
        codes.append(p.exitcode)
    print(codes)
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
