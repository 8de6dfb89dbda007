#!/usr/bin/env python3
"""Phase 10 of chip_smoke.py alone: the v1 join on an index that the v2
tables refuse.

    python3 scripts/torch_join_v1.py [--genome BASES] [--reads N]
                                     [--device cuda|cpu] [--force-v1]

Builds a random genome of ``--genome`` bases (default 140 Mb) cut into 1 kb
unitigs and ``--reads`` 9 kb reads with 8 % noise (default 2,048), and runs
``chip_smoke.phase_join_v1``, which prints one JSON line: the index and
join-table builds, the bytes on the device, device and host mapping walls
with refinement off and on, the overflow share, peak CUDA memory and, on the
card, the v1 join's four parts timed on one full batch.  It fails where the
v2 tables take the index, or where device mapping differs from host
mapping.  ``--force-v1`` makes the mapper refuse the v2 tables whatever the
index, so that ``--device cpu --genome 2000000 --reads 300 --force-v1``
rehearses the phase on the CPU at a small size; its times are the CPU's.
On the card the kernels are built first, as the smoke does.  ``--profile``
then maps the same reads once more under cProfile and, on the card,
``torch.profiler``, and prints one JSON line: the call's wall, the kernels'
summed device time, the three kernels that took the most, and the host
functions with the most cumulative time.
"""

from __future__ import annotations

import argparse
import cProfile
import importlib.util
import io
import json
import pstats
import subprocess
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile_map_all(card: str, device: torch.device, genome_length: int, n_reads: int,
                    smoke) -> None:
    """One more device mapping of phase 10's reads, profiled."""
    from muchsalsa_tpu_torch.config import Config
    from muchsalsa_tpu_torch.pipeline import mapper_torch as mt

    unitigs, reads = smoke.join_v1_data(genome_length, n_reads)
    cfg = Config().mapper
    index = mt.MinimizerIndex.build(unitigs, cfg)
    mt.map_all(index, reads, cfg, device=True, torch_device=device)  # warm
    on_card = device.type == "cuda"
    prof = cProfile.Profile()
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
            t0 = time.perf_counter()
            prof.runcall(mt.map_all, index, reads, cfg, device=True, torch_device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = sorted(((getattr(e, "self_device_time_total", 0), e.key)
                       for e in tp.key_averages()), reverse=True)
        device_s = sum(t for t, _ in rows) / 1e6
        kernels = [[k, t / 1e6] for t, k in rows[:3]]
    else:
        t0 = time.perf_counter()
        prof.runcall(mt.map_all, index, reads, cfg, device=True, torch_device=device)
        wall = time.perf_counter() - t0
        device_s, kernels = "not measured", []
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(14)
    print(json.dumps({
        "phase": "join_v1_profile", "card": card, "wall_s": wall, "device_s": device_s,
        "top_kernels": kernels, "stats": dict(mt.DEVICE_MAP_STATS),
        "cprofile": [ln.strip() for ln in buf.getvalue().splitlines()
                     if ln.strip()[:1].isdigit()]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome", type=int, default=None)
    ap.add_argument("--reads", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--force-v1", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    smoke = load_smoke()
    if args.device == "cuda":
        from muchsalsa_tpu_torch import kernels

        kernels.build()
        kernels.load()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    else:
        card = "cpu"
    if args.force_v1:
        from muchsalsa_tpu_torch.pipeline import mapper_torch

        mapper_torch.build_device_tables = lambda *a, **k: None
    genome = args.genome or smoke.JOIN_V1_GENOME
    n_reads = args.reads or smoke.JOIN_V1_READS
    smoke.phase_join_v1(card, torch.device(args.device), genome_length=genome,
                        n_reads=n_reads, expect_refusal=not args.force_v1)
    if args.profile:
        profile_map_all(card, torch.device(args.device), genome, n_reads, smoke)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
