#!/usr/bin/env python3
"""One process of the port's cross-process core assembly.

Every process replays the deterministic graph phases (ingest, edges,
chaining, contraction, spanning), then assembles its round-robin share of
the connected components; path lists and output buffers cross through
``torch_record_allgather`` (gloo), and every process writes the identical
output (the caller keeps one).  Edges and chaining run on ``--device``,
sharded over this process's own visible cards where it sees several: a
launcher that gives each process its own card sets ``CUDA_VISIBLE_DEVICES``.

    PYTHONPATH=. python3 scripts/torch_distributed_core.py <pid> <nprocs> \\
        <host:port> <mapped.paf> <unitigs.fa> <reads.fa> <outdir> [--device cuda|cpu] \\
        [--config config.json]

The counterpart of ``scripts/distributed_core.py``; it imports nothing of
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
    ap.add_argument("paf")
    ap.add_argument("unitigs")
    ap.add_argument("reads")
    ap.add_argument("outdir", type=Path)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", help="JSON config file (default: the default config)")
    args = ap.parse_args()

    import torch.distributed as dist

    from muchsalsa_tpu_torch.assemble.driver import assemble
    from muchsalsa_tpu_torch.config import DEFAULT_CONFIG, Config
    from muchsalsa_tpu_torch.parallel.mesh import init_distributed, process_count
    from muchsalsa_tpu_torch.pipeline.scrubber import torch_record_allgather

    init_distributed(args.coordinator, args.nprocs, args.pid)
    try:
        if process_count() != args.nprocs:
            raise SystemExit(f"{process_count()} processes in the group, {args.nprocs} asked")
        args.outdir.mkdir(parents=True, exist_ok=True)
        config = Config.load(args.config) if args.config else DEFAULT_CONFIG
        summary = assemble(args.paf, args.unitigs, args.reads, args.outdir, config,
                           process_index=args.pid, process_count=args.nprocs,
                           allgather=torch_record_allgather, device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[torch_distributed_core] p{args.pid}/{args.nprocs}: components="
          f"{summary['components']} paths={summary['paths']} mesh_devices="
          f"{summary['timer'].counters['mesh_devices']}", flush=True)
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "muchsalsa_tpu")]
    if loaded:
        raise SystemExit(f"the port loaded {loaded[:8]}")


if __name__ == "__main__":
    main()
