#!/usr/bin/env python3
"""Phase 9 of chip_smoke.py alone: ``full`` with its device legs on the card
against the same pipeline with every leg on the host, on phase 4's genome.

    python3 scripts/torch_full_legs.py [--genome BASES] [--device cuda|cpu]

Builds the data as chip_smoke.py does (phase 4's simulation at
``--genome`` bases, default 4.6 Mb; its reads with 8 % noise as the long
reads, Illumina pairs at 25x) and runs ``chip_smoke.phase_full``, which
prints one JSON line: each stage's wall in both runs, the k-mer, DBG and
scrub legs' walls side by side, each scrub subset's multiplicity and index
chunks, and which files are byte-identical; it fails where a leg did not
run on the card or a file differs.  Then it times each leg's device
function alone against its host function on the same inputs (host clock
around a synchronised call, first call and a second one), one JSON line a
leg, and where one more device call's time goes (cProfile's top host
functions; on the card, ``torch.profiler``'s summed kernel time).
``--device cpu`` rehearses on CPU tensors at a small ``--genome``;
its times are the CPU's.  The kernels are built first, as the smoke does.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed(fn, sync):
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def where_time_goes(fn, sync, on_card: bool, top: int = 12) -> dict:
    """One more call of ``fn`` under cProfile (the host functions with the
    most cumulative time) and, on the card, ``torch.profiler`` (the kernels'
    own device time, summed, and the three kernels that took the most)."""
    import cProfile
    import io
    import pstats

    prof = cProfile.Profile()
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
            t0 = time.perf_counter()
            prof.runcall(fn)
            sync()
            wall = time.perf_counter() - t0
        rows = [(getattr(e, "self_device_time_total", 0), e.key) for e in tp.key_averages()]
        device_s = sum(t for t, _ in rows) / 1e6
        kernels = [[k, t / 1e6] for t, k in sorted(rows, reverse=True)[:3]]
    else:
        t0 = time.perf_counter()
        prof.runcall(fn)
        wall = time.perf_counter() - t0
        device_s, kernels = None, []
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(top)
    lines = [ln.strip() for ln in buf.getvalue().splitlines() if ln.strip()[:1].isdigit()]
    return {"wall_s": wall, "device_s": device_s, "top_kernels": kernels, "cprofile": lines}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome", type=int, default=4_600_000)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    from muchsalsa_tpu_torch.config import Config
    from muchsalsa_tpu_torch.device import resolve_device
    from muchsalsa_tpu_torch.io.fasta import SequenceStore
    from muchsalsa_tpu_torch.ops.dbg_torch import ext_indices_device
    from muchsalsa_tpu_torch.ops.kmer_torch import count_kmers_device
    from muchsalsa_tpu_torch.pipeline.dbg import UnitigBuilder
    from muchsalsa_tpu_torch.pipeline.kmer import count_kmers
    from muchsalsa_tpu_torch.pipeline.scrubber import SCRUB_DEVICE_STATS, scrub_reads
    from muchsalsa_tpu_torch.testing.simulate import add_noise, simulate

    dev = resolve_device(args.device)
    smoke = load_smoke()
    if dev.type == "cuda":
        from muchsalsa_tpu_torch import kernels

        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
        kernels.build()
        kernels.load()
        sync = torch.cuda.synchronize
    else:
        card = "cpu"
        sync = lambda: None  # noqa: E731
        # phase_full reads the card's peak memory
        torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
        torch.cuda.max_memory_allocated = lambda *a, **k: 0
    print(card, flush=True)

    t0 = time.perf_counter()
    sim = simulate(np.random.default_rng(20260819), genome_length=args.genome, coverage=15.0,
                   read_length=9_000, unitig_length=1_000, unitig_gap=300)
    reads = SequenceStore()
    noise_rng = np.random.default_rng(1)
    for name, seq in sim.read_records():
        reads.add(name, add_noise(noise_rng, seq, 0.08))
    smoke.emit("legs_data", card=card, genome=args.genome, reads=len(reads),
               seconds=time.perf_counter() - t0)

    with tempfile.TemporaryDirectory(prefix="ms_full_legs_") as td:
        work = Path(td)
        try:
            smoke.phase_full(card, work, sim, reads, str(dev))
        except AssertionError as err:
            # on CPU tensors the wrappers run their plain versions, which
            # count no launch; every other check of the phase stands
            if dev.type == "cuda" or "did not launch" not in str(err):
                raise
        host_out = work / "full_host"
        cfg = Config()
        illu = SequenceStore.from_file(host_out / "01_illu_filtered.fa")
        filtered = [illu.sequence(i) for i in illu.ids()]
        raw = [s for f in ("illu_1.fa", "illu_2.fa")
               for st in [SequenceStore.from_file(work / "full_data" / f)]
               for s in (st.sequence(i) for i in st.ids())]
        k_filter = cfg.pipeline.kmer_k_filter

        for call in ("first", "second"):
            (hu, hc), host_s = timed(lambda: count_kmers(raw, k_filter), sync)
            (du, dc), dev_s = timed(lambda: count_kmers_device(raw, k_filter, device=dev), sync)
            same = np.array_equal(hu, du) and np.array_equal(hc, dc)
            smoke.emit("leg_kmer", card=card, call=call, seqs=len(raw), distinct=len(hu),
                       host_s=host_s, device_s=dev_s, identical=same)
        smoke.emit("leg_kmer_profile", card=card, **where_time_goes(
            lambda: count_kmers_device(raw, k_filter, device=dev), sync, dev.type == "cuda"))

        builder = UnitigBuilder(filtered, k=31, min_count=2)
        vals = np.ascontiguousarray(builder._kmers_sorted, dtype=np.uint64)
        for call in ("first", "second"):
            _ext, ext_s = timed(lambda: ext_indices_device(vals, 31, device=dev), sync)
            host_u, host_s = timed(lambda: builder.build(cfg.pipeline.min_unitig_length), sync)
            dev_u, dev_s = timed(lambda: builder.build(cfg.pipeline.min_unitig_length,
                                                       device=dev), sync)
            smoke.emit("leg_dbg", card=card, call=call, kmers=len(vals), ext_table_s=ext_s,
                       host_build_s=host_s, device_build_s=dev_s, identical=host_u == dev_u)
        smoke.emit("leg_dbg_profile", card=card, **where_time_goes(
            lambda: builder.build(cfg.pipeline.min_unitig_length, device=dev), sync,
            dev.type == "cuda"))

        nano = SequenceStore.from_file(work / "full_data" / "nanopore.fa")
        lines = [ln for ln in (host_out / "01_contigs_corrected.paf").read_text().splitlines()
                 if ln and "__sentinel__" not in ln]
        for call in ("first", "second"):
            host_r, host_s = timed(lambda: scrub_reads(lines, nano, cfg.scrub, cfg.mapper), sync)
            dev_r, dev_s = timed(lambda: scrub_reads(lines, nano, cfg.scrub, cfg.mapper,
                                                     device=dev), sync)
            smoke.emit("leg_scrub", card=card, call=call, paf_lines=len(lines), host_s=host_s,
                       device_s=dev_s, identical=host_r == dev_r,
                       stats=json.loads(json.dumps(SCRUB_DEVICE_STATS)))
        smoke.emit("leg_scrub_profile", card=card, **where_time_goes(
            lambda: scrub_reads(lines, nano, cfg.scrub, cfg.mapper, device=dev), sync,
            dev.type == "cuda"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
