#!/usr/bin/env python3
"""The k-mer leg of ``full`` alone at a scale row, with its chunks' runs
merged in groups and merged only at the end.

    PYTHONPATH=. python3 scripts/torch_kmer_merge.py [genome_mb=40] [--device {cuda,cpu}]

Writes the row's inputs (``testing/scale.py::make_scale_inputs``: 30x
Illumina pairs of a ``genome_mb`` Mb genome) into
``build/torch_kmer_merge`` and counts the k-mers of ``full``'s stage ①
(k = ``Config().pipeline.kmer_k_filter``) with ``count_kmers_device``
twice: at its default ``merge_elems`` (runs merged on the device in groups)
and with ``merge_elems`` past any count, so that every chunk's runs stay
on the device until one merge at the end, as before the groups.  Prints,
on the card, its name and power limit as ``nvidia-smi`` gives them, then
one JSON line: each way's wall, peak CUDA memory and counters, and whether
the two results are equal.  Exits 1 where they differ.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent


def main(argv: list[str]) -> int:
    from muchsalsa_tpu_torch.config import Config
    from muchsalsa_tpu_torch.device import resolve_device
    from muchsalsa_tpu_torch.ops.kmer_torch import KMER_DEVICE_STATS, count_kmers_device
    from muchsalsa_tpu_torch.pipeline.full import _read_pairs
    from muchsalsa_tpu_torch.testing.scale import make_scale_inputs

    genome_mb = float(argv[1]) if len(argv) > 1 and not argv[1].startswith("--") else 40.0
    dev = resolve_device(argv[argv.index("--device") + 1] if "--device" in argv else "cuda")
    on_card = dev.type == "cuda"
    k = Config().pipeline.kmer_k_filter
    t0 = time.perf_counter()
    inputs = make_scale_inputs(REPO / "build" / "torch_kmer_merge", genome_mb)
    seqs = [s for p in _read_pairs(inputs["illu1.fa"], inputs["illu2.fa"]) for s in p if s]
    record = {"genome_mb": genome_mb, "k": k, "device": str(dev), "reads": len(seqs),
              "inputs_s": time.perf_counter() - t0, "card": None}
    if on_card:
        record["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    results = {}
    for name, merge_elems in (("groups", None), ("at_end", 1 << 62)):
        kw = {} if merge_elems is None else {"merge_elems": merge_elems}
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results[name] = count_kmers_device(seqs, k, device=dev, **kw)
        record[name] = {"wall_s": time.perf_counter() - t0,
                        "cuda_peak_bytes": torch.cuda.max_memory_allocated() if on_card else None,
                        **KMER_DEVICE_STATS}
    (u1, c1), (u2, c2) = results.values()
    record["equal"] = bool(np.array_equal(u1, u2) and np.array_equal(c1, c2))
    if record["card"] is not None:
        print(record["card"], flush=True)
    print(json.dumps(record), flush=True)
    return 0 if record["equal"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
