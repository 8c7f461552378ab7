"""How fast a gather over a gloo group moves data: gloo's ``all_gather``
against the port's ``sharding.collectives._gather_parts`` (one
``broadcast`` from each rank, in rank order), on host tensors.

    PYTHONPATH=src python tools/gloo_gather_probe.py [--ranks 2]
        [--mb 300] [--reps 3]

Starts ``--ranks`` processes of itself on one host, joined through a
FileStore in a temporary directory, each with one intra-op thread.  Each
gathers a bf16 tensor of ``--mb`` MB from every rank, ``--reps`` times
each way, and rank 0 prints the seconds of each gather and the GB a rank
received a second ((ranks - 1) parts).  Both ways give every rank the
same parts in rank order; the probe checks that they agree.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def rank_main(rank: int, world: int, store: str, mb: int, reps: int) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.sharding.collectives import _gather_parts

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        n = mb * 1_000_000 // 2
        x = torch.full((n,), float(rank + 1), dtype=torch.bfloat16)
        received = (world - 1) * n * 2

        def all_gather():
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x)
            return parts

        def broadcasts():
            return _gather_parts(x, dist.group.WORLD, world)

        got = {}
        for label, fn in (("all_gather", all_gather),
                          ("broadcasts", broadcasts)):
            for i in range(reps):
                dist.barrier()
                t = time.perf_counter()
                got[label] = fn()
                dt = time.perf_counter() - t
                if rank == 0:
                    print(f"{label} {i}: {dt:.3f} s, "
                          f"{received / dt / 1e9:.3f} GB/s received",
                          flush=True)
        if not all(torch.equal(a, b) for a, b in zip(got["all_gather"],
                                                      got["broadcasts"])):
            print(f"rank {rank}: the two gathers differ", flush=True)
            return 1
    finally:
        dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--mb", type=int, default=300)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args.rank, args.ranks, args.store, args.mb,
                         args.reps)
    with tempfile.TemporaryDirectory() as work:
        store = str(Path(work) / "store")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--ranks",
             str(args.ranks), "--store", store, "--mb", str(args.mb),
             "--reps", str(args.reps)]) for r in range(args.ranks)]
        rcs = [p.wait() for p in procs]
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
