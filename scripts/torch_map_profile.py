"""Where the port's device mapping spends its time, on one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/torch_map_profile.py [--out build/map_profile]

Builds ``chip_smoke.py`` phase 7's data (a 4.6 Mb genome, 15x of 9 kb reads
with 8 % nanopore-style noise, 1 kb unitigs) and maps the reads with the
port's ``map_all_with_device`` on the card:

- the host mapper's wall (``map_batch``) for comparison;
- the first call, split into the table build (host numpy and the copy to
  the card) and the mapping with those tables;
- two calls served by the store's batch cache;
- one cached call under ``torch.profiler`` (CPU and CUDA activities):
  device time summed over kernels and copies, the busy share of the wall,
  the largest kernels; the table goes to ``<out>/torch_profiler.txt``;
- one cached call under ``cProfile``; the listing goes to
  ``<out>/cprofile.txt``.

Prints one JSON line per measurement, each naming the card.  Needs a card.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from muchsalsa_tpu_torch.config import Config
from muchsalsa_tpu_torch.ops.mapping_torch import build_device_tables
from muchsalsa_tpu_torch.pipeline.mapper_torch import (
    DEVICE_MAP_STATS, MinimizerIndex, SequenceStore, map_all_with_device, map_batch)
from muchsalsa_tpu_torch.testing.simulate import add_noise, simulate


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=Path, default=Path("build/map_profile"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_map_profile: no CUDA device")
    args.out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]

    sim = simulate(np.random.default_rng(20260819), genome_length=4_600_000, coverage=15.0,
                   read_length=9_000, unitig_length=1_000, unitig_gap=300)
    unitigs, reads = SequenceStore(), SequenceStore()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    rng = np.random.default_rng(1)
    for name, seq in sim.read_records():
        reads.add(name, add_noise(rng, seq, 0.08))
    cfg = Config().mapper
    index = MinimizerIndex.build(unitigs, cfg)

    t0 = time.perf_counter()
    host = map_batch(index, reads, cfg)
    emit(phase="host", card=card, reads=len(reads), wall_s=time.perf_counter() - t0)

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    built = build_device_tables(index.hashes, index.offsets, index.entry_unitig,
                                index.entry_pos, index.entry_strand, device=dev)
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0

    def call() -> float:
        t0 = time.perf_counter()
        out = map_all_with_device(index, reads, cfg, prebuilt=built, device=dev)
        wall = time.perf_counter() - t0
        if out != host:
            raise AssertionError("device mapping differs from host mapping")
        return wall

    emit(phase="cold", card=card, tables_s=tables_s, map_s=call(), stats=dict(DEVICE_MAP_STATS))
    emit(phase="cached", card=card, walls_s=[call(), call()])

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = call()
    averages = prof.key_averages()
    col = ("self_device_time_total" if hasattr(averages[0], "self_device_time_total")
           else "self_cuda_time_total")
    # only the kernels and copies themselves: an aten op's device time is
    # its kernels' again
    by_name = sorted(((e.key, getattr(e, col)) for e in averages
                      if e.device_type == DeviceType.CUDA), key=lambda kv: -kv[1])
    device_us = sum(us for _, us in by_name)
    (args.out / "torch_profiler.txt").write_text(averages.table(
        sort_by=col, row_limit=40, max_name_column_width=70))
    emit(phase="torch_profiler", card=card, wall_s=wall, device_ms=device_us / 1e3,
         device_busy_share=device_us / 1e6 / wall,
         top_device_ms={k[:90]: us / 1e3 for k, us in by_name[:12] if us})

    prof_c = cProfile.Profile()
    prof_c.enable()
    call()
    prof_c.disable()
    listing = io.StringIO()
    pstats.Stats(prof_c, stream=listing).sort_stats("cumulative").print_stats(40)
    (args.out / "cprofile.txt").write_text(listing.getvalue())
    stats = pstats.Stats(prof_c).stats
    emit(phase="cprofile", top_tottime_s={
        f"{Path(f).name}:{ln}:{fn}": tt for (f, ln, fn), (_, _, tt, _, _) in sorted(
            stats.items(), key=lambda kv: -kv[1][2])[:15]})


if __name__ == "__main__":
    main()
