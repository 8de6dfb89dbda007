"""Command-line interface of the port: ``core``, ``map``, ``full`` and ``config``.

    python -m muchsalsa_tpu_torch.pipeline.cli core <paf> <unitigs> <nanopore> <outdir>
        [threads] [wiggle_room] --device {cuda,cpu}
    python -m muchsalsa_tpu_torch.pipeline.cli map <query_fa> <target_fa> <out_paf>
        [--no-device-map] --device {cuda,cpu}
    python -m muchsalsa_tpu_torch.pipeline.cli full --illumina1 A [--illumina2 B]
        --nanopore N --out DIR [--no-device-map] [--[no-]device-{kmer,dbg,scrub}]
        --device {cuda,cpu}
    python -m muchsalsa_tpu_torch.pipeline.cli config

``core`` is the reference muchsalsa binary's positional CLI
(``src/Application.cpp:32-39``); ``map`` and ``full`` take the JAX
package's arguments (``muchsalsa_tpu/pipeline/cli.py:62-93``), with the
torch device named.  The default device is ``cuda``, and a machine without
a card raises instead of running on the CPU: CPU runs say ``--device cpu``.
``map`` and ``full`` map on the device unless ``--no-device-map``; ``full``
runs the k-mer, DBG and scrub device legs on a card unless ``--no-device-*``
says otherwise (on the CPU they are off unless ``--device-*`` asks).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

from muchsalsa_tpu_torch.config import DEFAULT_CONFIG, Config


def _missing(paths) -> bool:
    """The reference's integrity check (Application::checkIntegrity,
    Application.cpp:53-63): report the first missing input."""
    for p in paths:
        if not Path(p).is_file():
            print("Paths are pointing to invalid/unusable locations", file=sys.stderr)
            print(f"  missing: {p}", file=sys.stderr)
            return True
    return False


def _device_arg(parser, what: str) -> None:
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help=f"where {what} run (default cuda; raises when no card is present)")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="muchsalsa-tpu-torch")
    parser.add_argument("--config", help="JSON config file", default=None)
    sub = parser.add_subparsers(dest="command", required=True)

    core = sub.add_parser("core", help="core assembly (reference muchsalsa CLI)")
    core.add_argument("paf")
    core.add_argument("unitigs")
    core.add_argument("nanopore")
    core.add_argument("outdir")
    core.add_argument(
        "threads", nargs="?", type=int, default=None,
        help="host worker processes for the assembly fan-out (default 1)",
    )
    core.add_argument("wiggle_room", nargs="?", type=int, default=None)
    _device_arg(core, "edges and chaining")

    full = sub.add_parser("full", help="full pipeline from raw reads")
    full.add_argument("--illumina1", required=True)
    full.add_argument("--illumina2", default=None)
    full.add_argument("--nanopore", required=True)
    full.add_argument("--out", required=True)
    full.add_argument("--kmer-filter-k", type=int, default=None)
    full.add_argument("--unitig-k", type=int, default=31)
    full.add_argument("--device-map", action=argparse.BooleanOptionalAction, default=True,
                      help="map on --device (default; identical output, overflowing "
                      "reads on the host); --no-device-map maps on the host")
    for leg, stage in (("kmer", "the k-mer filter's counting"),
                       ("scrub", "the scrub's all-vs-all mapping"),
                       ("dbg", "the unitig build's extension table")):
        full.add_argument(f"--device-{leg}", action=argparse.BooleanOptionalAction,
                          default=None, help=f"run {stage} on --device (default: on for "
                          f"cuda, off for cpu); --no-device-{leg} runs it on the host")
    _device_arg(full, "device mapping, refinement, edges and chaining")

    mp = sub.add_parser("map", help="native minimizer mapper (PAF out)")
    mp.add_argument("query_fa", help="unitigs/anchors (PAF query)")
    mp.add_argument("target_fa", help="long reads (PAF target)")
    mp.add_argument("out_paf")
    mp.add_argument("--device-map", action=argparse.BooleanOptionalAction, default=True,
                    help="map on --device (default; identical output, overflowing reads "
                    "on the host); --no-device-map maps on the host")
    _device_arg(mp, "device mapping")

    sub.add_parser("config", help="print the default config JSON")

    args = parser.parse_args(argv)
    config = Config.load(args.config) if args.config else DEFAULT_CONFIG

    if args.command == "config":
        print(config.to_json())
        return 0

    if args.command == "core":
        if _missing((args.paf, args.unitigs, args.nanopore)):
            return 1
        if args.wiggle_room is not None:
            graph = dataclasses.replace(config.graph, wiggle_room=args.wiggle_room)
            config = dataclasses.replace(config, graph=graph)
        from muchsalsa_tpu_torch.assemble.driver import assemble

        result = assemble(
            args.paf, args.unitigs, args.nanopore, args.outdir, config,
            workers=args.threads, device=args.device,
        )
        print("Finished assembly")
        print(f"components={result['components']} paths={result['paths']}")
        return 0

    if args.command == "full":
        if _missing([p for p in (args.illumina1, args.nanopore, args.illumina2) if p]):
            return 1
        from muchsalsa_tpu_torch.pipeline.full import run_full_pipeline

        final = run_full_pipeline(
            args.illumina1, args.illumina2, args.nanopore, args.out, config,
            kmer_filter_k=args.kmer_filter_k, unitig_k=args.unitig_k, device=args.device,
            device_map=args.device_map, device_kmer=args.device_kmer,
            device_scrub=args.device_scrub, device_dbg=args.device_dbg,
        )
        print(f"Assembly written to {final}")
        return 0

    # map
    if _missing((args.query_fa, args.target_fa)):
        return 1
    from muchsalsa_tpu_torch.pipeline.mapper_torch import (
        MinimizerIndex, SequenceStore, map_all, write_paf)

    unitigs = SequenceStore.from_file(args.query_fa)
    reads = SequenceStore.from_file(args.target_fa)
    index = MinimizerIndex.build(unitigs, config.mapper)
    lines = map_all(
        index, reads, config.mapper,
        unitig_names=lambda u: unitigs.registry.name(u),
        read_names=lambda r: reads.registry.name(r),
        device=args.device_map, torch_device=args.device,
    )
    write_paf(lines, args.out_paf)
    print(f"{len(lines)} mappings written to {args.out_paf}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
