#!/usr/bin/env python3
"""Which genome sizes the v2 join tables refuse, on the host.

    python3 scripts/v2_refusal_sizes.py [MEGABASES ...]

For each size (default 4.6 12 40 60 80 140 Mb) a random genome
(``testing.simulate.random_genome``, seed 20260819) is cut into contiguous
1 kb unitigs and indexed with the default ``MapperConfig``; then the port's
``build_device_tables`` is asked for the v2 tables on the CPU.  One JSON line
a size: the distinct hashes H and entries E, the largest probe bucket (the
hash's top 22 bits) and the number of buckets over the 31 that the tables
hold, whether the tables were built, and the host seconds of the genome, the
index and the table build.  Needs a few GiB of host memory at 140 Mb.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from muchsalsa_tpu_torch.config import MapperConfig
from muchsalsa_tpu_torch.ops.mapping_torch import RANK2_LOG2, build_device_tables
from muchsalsa_tpu_torch.pipeline.mapper import MinimizerIndex
from muchsalsa_tpu_torch.pipeline.mapper_torch import SequenceStore
from muchsalsa_tpu_torch.testing.simulate import random_genome

UNITIG = 1_000
CAP = 31  # distinct hashes a probe bucket of the v2 tables can hold


def main(sizes_mb: list[float]) -> int:
    for mb in sizes_mb:
        n = int(mb * 1e6)
        t0 = time.perf_counter()
        genome = random_genome(np.random.default_rng(20260819), n)
        genome_s = time.perf_counter() - t0
        unitigs = SequenceStore()
        for i, s in enumerate(range(0, n - UNITIG + 1, UNITIG)):
            unitigs.add(f"u{i}", genome[s : s + UNITIG])
        del genome
        t0 = time.perf_counter()
        index = MinimizerIndex.build(unitigs, MapperConfig())
        index_s = time.perf_counter() - t0
        bcnt = np.bincount(index.hashes >> np.uint32(32 - RANK2_LOG2), minlength=1 << RANK2_LOG2)
        t0 = time.perf_counter()
        built = build_device_tables(index.hashes, index.offsets, index.entry_unitig,
                                    index.entry_pos, index.entry_strand, device="cpu")
        tables_s = time.perf_counter() - t0
        print(json.dumps({
            "genome_mb": mb, "hashes": len(index.hashes), "entries": int(index.offsets[-1]),
            "largest_bucket": int(bcnt.max()), "buckets_over_cap": int((bcnt > CAP).sum()),
            "v2_tables": "built" if built is not None else "refused", "genome_s": genome_s,
            "index_s": index_s, "tables_s": tables_s}), flush=True)
        del unitigs, index, built
    return 0


if __name__ == "__main__":
    raise SystemExit(main([float(a) for a in sys.argv[1:]] or [4.6, 12, 40, 60, 80, 140]))
