#!/usr/bin/env python3
"""Device mapping's overflow rate on a repeat-rich genome, through the
PyTorch port: the twin of ``scripts/overflow_probe.py`` (the JAX package's).

    PYTHONPATH=. python3 scripts/torch_overflow_probe.py [genome_mb=40] \\
        [dup_frac=0.15] [n_reads=2000] [--device {cuda,cpu}]

The same genome from the same random numbers (``default_rng(99)``): a
random genome of which ``dup_frac`` is duplicated material, 70 % segmental
duplications (5-40 kb blocks copied elsewhere at 2 % divergence) and 30 %
tandem repeats (a 0.5-4 kb unit 3-10 times at 1 % divergence); 1 kb
unitigs every 1.3 kb indexed; ``n_reads`` reads of 9 kb at 5 % noise
mapped by the port's ``map_all_with_device`` on ``--device`` (default
``cuda``, which raises without a card).  Prints the JAX script's
``[overflow]`` lines (the index, how many minimizers have more than 4, 8
and 16 entries, the overflow share and ``DEVICE_MAP_STATS``, and where reads
overflowed the host mapper's cost for them), then, on the card, its name
and power limit as ``nvidia-smi`` gives them, and one JSON line of the same
figures.  The budgets and so the per-budget breakdown do not depend on the
device: on the CPU it equals the JAX script's.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

DEVICES = ("cuda", "cpu")


def parse_args(argv: list[str]) -> dict:
    """``genome_mb dup_frac n_reads`` by place, as the JAX script reads
    them, then ``--device cuda|cpu``."""
    device = "cuda"
    if "--device" in argv:
        at = argv.index("--device") + 1
        device = argv[at] if at < len(argv) else ""
        if device not in DEVICES:
            raise ValueError(f"--device takes one of {DEVICES}, not {device!r}")
    return {"genome_mb": float(argv[1]) if len(argv) > 1 else 40.0,
            "dup_frac": float(argv[2]) if len(argv) > 2 else 0.15,
            "n_reads": int(argv[3]) if len(argv) > 3 else 2000,
            "device": device}


def repeat_rich_genome(rng, length: int, dup_frac: float) -> bytes:
    """A genome where ~``dup_frac`` of the final sequence is duplicated
    material: 70% segmental duplications (5-40 kb blocks copied to a
    random position, 2% divergence), 30% tandem repeats (0.5-4 kb unit
    repeated 3-10x, 1% divergence)."""
    from muchsalsa_tpu_torch.testing.simulate import add_noise, random_genome

    base_len = int(length * (1.0 - dup_frac))
    genome = bytearray(random_genome(rng, base_len))
    target_dup = length - base_len
    added = 0
    while added < target_dup:
        if rng.random() < 0.7:
            blk = int(rng.integers(5_000, 40_000))
            src = int(rng.integers(0, max(1, len(genome) - blk)))
            copy = add_noise(rng, bytes(genome[src : src + blk]), 0.02)
        else:
            unit_len = int(rng.integers(500, 4_000))
            src = int(rng.integers(0, max(1, len(genome) - unit_len)))
            unit = bytes(genome[src : src + unit_len])
            n = int(rng.integers(3, 10))
            copy = b"".join(add_noise(rng, unit, 0.01) for _ in range(n))
        pos = int(rng.integers(0, len(genome)))
        genome[pos:pos] = copy
        added += len(copy)
    return bytes(genome[:length])


def main(argv: list[str] | None = None) -> int:
    args = parse_args(sys.argv if argv is None else argv)
    genome_mb, dup_frac, n_reads = args["genome_mb"], args["dup_frac"], args["n_reads"]

    from muchsalsa_tpu_torch.config import MapperConfig
    from muchsalsa_tpu_torch.device import resolve_device
    from muchsalsa_tpu_torch.io.fasta import SequenceStore
    from muchsalsa_tpu_torch.pipeline.mapper import map_read
    from muchsalsa_tpu_torch.pipeline.mapper_torch import (
        DEVICE_MAP_STATS, MinimizerIndex, map_all_with_device)
    from muchsalsa_tpu_torch.testing.simulate import add_noise

    dev = resolve_device(args["device"])
    on_card = dev.type == "cuda"
    record = {"genome_mb": genome_mb, "dup_frac": dup_frac, "n_reads": n_reads,
              "device": str(dev), "card": None}
    if on_card:
        record["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]

    rng = np.random.default_rng(99)
    t0 = time.perf_counter()
    L = int(genome_mb * 1e6)
    genome = repeat_rich_genome(rng, L, dup_frac)
    record["genome_s"] = time.perf_counter() - t0
    print(f"[overflow] {genome_mb} Mb genome, dup_frac={dup_frac} "
          f"({record['genome_s']:.0f}s)", flush=True)

    # unitigs tile the genome like the pipeline's DBG output (1 kb every
    # 1.3 kb); repeats make many of them multi-copy
    unitigs = SequenceStore()
    step, ulen = 1_300, 1_000
    for i in range(0, L - ulen, step):
        unitigs.add(f"u{i}", genome[i : i + ulen])
    cfg = MapperConfig()
    t0 = time.perf_counter()
    index = MinimizerIndex.build(unitigs, cfg)
    record.update(index_s=time.perf_counter() - t0, hashes=len(index.hashes),
                  entries=len(index.entry_pos))
    print(f"[overflow] index: {record['hashes']} hashes, {record['entries']} entries "
          f"({record['index_s']:.0f}s)", flush=True)

    # per-entry-count histogram: how hot the repeat minimizers are
    counts = np.diff(index.offsets)
    record["hot_share"] = {}
    for thr in (4, 8, 16):
        frac = float((counts > thr).mean())
        record["hot_share"][thr] = frac
        print(f"[overflow] minimizers with >{thr} entries: {100*frac:.2f}%", flush=True)

    reads = SequenceStore()
    for i in range(n_reads):
        s = int(rng.integers(0, L - 9_000))
        reads.add(f"r{i}", add_noise(rng, genome[s : s + 9_000], 0.05))

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    DEVICE_MAP_STATS.clear()
    t0 = time.perf_counter()
    map_all_with_device(index, reads, cfg, device=dev)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ovf = DEVICE_MAP_STATS.get("overflow_reads", 0)
    record.update(map_s=wall, overflow_reads=ovf, overflow_share=ovf / n_reads,
                  stats=dict(DEVICE_MAP_STATS),
                  cuda_peak_bytes=torch.cuda.max_memory_allocated() if on_card else None)
    print(f"[overflow] device-path map of {n_reads} reads: {wall:.1f}s; "
          f"overflow {ovf}/{n_reads} = {100.0*ovf/n_reads:.2f}% "
          f"(stats={DEVICE_MAP_STATS})", flush=True)

    # the host fallback's wall share: the host mapper's cost a read, from a
    # sample, times the reads that overflowed
    if ovf:
        sample = [seq for _rid, seq in list(reads.items())[:200]]
        t0 = time.perf_counter()
        for seq in sample:
            map_read(index, seq, cfg)
        per_read = (time.perf_counter() - t0) / len(sample)
        record.update(host_ms_a_read=per_read * 1e3, fallback_s=ovf * per_read)
        print(f"[overflow] host map_read ~{per_read*1e3:.1f} ms/read -> "
              f"fallback wall ≈ {ovf*per_read:.1f}s of the {wall:.1f}s pass", flush=True)
    if record["card"] is not None:
        print(record["card"], flush=True)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
