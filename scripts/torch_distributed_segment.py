#!/usr/bin/env python3
"""One process of a scrub -> map -> core segment of the port across a
process group.

- scrub: the BFS subsets round-robin across processes, their overlap
  records allgathered, the merge and emit pass replayed in every process;
- map (scrubbed reads against the unitigs): the same work in every
  process;
- core: the connected components round-robin across processes, path lists
  and output buffers allgathered; edges and chaining on ``--device``.

With ``--device cuda`` the scrub's all-vs-all and the mapping run on the
card; with ``--device cpu`` both run on the host mapper, as ``full
--device cpu`` keeps its scrub leg on the host.

Every process writes identical files (the caller keeps one).

    PYTHONPATH=. python3 scripts/torch_distributed_segment.py <pid> <nprocs> \\
        <host:port> <reads.fa> <anchors.paf> <unitigs.fa> <outdir> [subset_size] \\
        [--device cuda|cpu]

The counterpart of ``scripts/distributed_segment.py``; it imports nothing
of JAX and fails if anything did.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

SENTINEL = "__sentinel__\t1\t0\t1\t+\t__sentinel__\t1\t0\t1\t0\t1\t0"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pid", type=int)
    ap.add_argument("nprocs", type=int)
    ap.add_argument("coordinator", help="host:port of the process group's store")
    ap.add_argument("reads")
    ap.add_argument("paf")
    ap.add_argument("unitigs")
    ap.add_argument("outdir", type=Path)
    ap.add_argument("subset_size", type=int, nargs="?", default=60_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import dataclasses

    import torch.distributed as dist

    from muchsalsa_tpu_torch.assemble.driver import assemble
    from muchsalsa_tpu_torch.config import MapperConfig, ScrubConfig
    from muchsalsa_tpu_torch.io.fasta import SequenceStore, write_fasta
    from muchsalsa_tpu_torch.parallel.mesh import init_distributed, process_count
    from muchsalsa_tpu_torch.pipeline.mapper_torch import MinimizerIndex, map_all, write_paf
    from muchsalsa_tpu_torch.pipeline.scrubber import scrub_reads, torch_record_allgather

    init_distributed(args.coordinator, args.nprocs, args.pid)
    try:
        if process_count() != args.nprocs:
            raise SystemExit(f"{process_count()} processes in the group, {args.nprocs} asked")
        out = args.outdir
        out.mkdir(parents=True, exist_ok=True)
        dist_kw = dict(process_index=args.pid, process_count=args.nprocs,
                       allgather=torch_record_allgather)

        on_card = args.device.startswith("cuda")
        reads = SequenceStore()
        reads.load(args.reads)
        mcfg = MapperConfig()
        scrubbed = scrub_reads(
            Path(args.paf).read_text().splitlines(), reads,
            dataclasses.replace(ScrubConfig(), subset_size=args.subset_size), mcfg,
            device=args.device if on_card else False, **dist_kw)
        write_fasta(out / "scrubbed.fa", scrubbed)

        unitigs = SequenceStore()
        unitigs.load(args.unitigs)
        sreads = SequenceStore()
        sreads.load(out / "scrubbed.fa")
        paf = map_all(MinimizerIndex.build(unitigs, mcfg), sreads, mcfg,
                      unitig_names=unitigs.registry.name, read_names=sreads.registry.name,
                      device=on_card, torch_device=args.device)
        # the core's parser drops the last PAF line: end with a sentinel
        write_paf(paf + [SENTINEL], out / "scrubbed.paf")

        summary = assemble(out / "scrubbed.paf", args.unitigs, out / "scrubbed.fa", out,
                           device=args.device, **dist_kw)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[torch_distributed_segment] p{args.pid}/{args.nprocs}: scrubbed={len(scrubbed)} "
          f"components={summary['components']} paths={summary['paths']}", flush=True)
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "muchsalsa_tpu")]
    if loaded:
        raise SystemExit(f"the port loaded {loaded[:8]}")


if __name__ == "__main__":
    main()
