#!/usr/bin/env python3
"""One process of the port's cross-process scrub.

Each process computes the all-vs-all overlaps of its round-robin share of
the BFS subsets; the per-subset record lists cross through
``torch_record_allgather`` (gloo); every process then replays the merge and
emit pass in subset order, so the output is identical to a single-process
run (process 0 writes it).  With ``--device cuda`` the all-vs-all maps on
the card; with ``--device cpu`` on the host mapper, as ``full --device
cpu`` keeps its scrub leg on the host.

    PYTHONPATH=. python3 scripts/torch_distributed_scrub.py <pid> <nprocs> \\
        <host:port> <reads.fa> <mapped.paf> <out.fa> [subset_size] [--device cuda|cpu]

The counterpart of ``scripts/distributed_scrub.py``; it imports nothing of
JAX and fails if anything did.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pid", type=int)
    ap.add_argument("nprocs", type=int)
    ap.add_argument("coordinator", help="host:port of the process group's store")
    ap.add_argument("reads")
    ap.add_argument("paf")
    ap.add_argument("out", type=Path)
    ap.add_argument("subset_size", type=int, nargs="?", default=60_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import dataclasses

    import torch.distributed as dist

    from muchsalsa_tpu_torch.config import MapperConfig, ScrubConfig
    from muchsalsa_tpu_torch.io.fasta import SequenceStore, write_fasta
    from muchsalsa_tpu_torch.parallel.mesh import init_distributed, process_count
    from muchsalsa_tpu_torch.pipeline.scrubber import (
        SCRUB_DEVICE_STATS, scrub_reads, torch_record_allgather)

    init_distributed(args.coordinator, args.nprocs, args.pid)
    try:
        if process_count() != args.nprocs:
            raise SystemExit(f"{process_count()} processes in the group, {args.nprocs} asked")
        reads = SequenceStore()
        reads.load(args.reads)
        lines = Path(args.paf).read_text().splitlines()
        scfg = dataclasses.replace(ScrubConfig(), subset_size=args.subset_size)
        out = scrub_reads(lines, reads, scfg, MapperConfig(), process_index=args.pid,
                          process_count=args.nprocs, allgather=torch_record_allgather,
                          device=args.device if args.device.startswith("cuda") else False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if args.pid == 0:
        write_fasta(args.out, out)
    on_card = SCRUB_DEVICE_STATS.get("on_device", 0)
    print(f"[torch_distributed_scrub] p{args.pid}/{args.nprocs}: {len(out)} records, "
          f"{on_card} subsets on {args.device}, "
          f"{SCRUB_DEVICE_STATS.get('declined', 0)} declined", flush=True)
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "muchsalsa_tpu")]
    if loaded:
        raise SystemExit(f"the port loaded {loaded[:8]}")


if __name__ == "__main__":
    main()
