"""The scale rows of ``full``: their inputs, their contig statistics and the
JAX package's outputs that the port must reproduce byte for byte.

Twin of the body of ``scripts/scale_run.py``, the JAX package's scale run:
``make_scale_inputs`` draws that script's random numbers in its order
(``default_rng(1234)``; a genome of ``genome_mb`` Mb, 9 kb long reads at
``coverage`` with 7 % noise, a fifth of them with a junk tail of 200-1,500
random bases at either end; error-free Illumina pairs at ``illu_cov``) and
writes its three files under its record names; ``contig_stats`` is its
contig summary.  ``SCALE_ROWS`` holds, a row each, what the JAX script
gave: the sha256 of its three inputs and of its
``03.assembly.unpolished.fa``, and its contig statistics.
``run_scale_row`` runs a row through the port's ``full`` and holds it to
its row; ``scripts/torch_scale_run.py`` and ``chip_smoke.py`` phase 12
call it.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import resource
import time
from pathlib import Path

import numpy as np
import torch

from muchsalsa_tpu_torch.io.fasta import write_fasta
from muchsalsa_tpu_torch.testing.simulate import add_noise, illumina_pairs, random_genome, simulate

INPUTS = ("nanopore.fa", "illu1.fa", "illu2.fa")
ASSEMBLY = "03.assembly.unpolished.fa"
# what a run's record keeps of each map stage's DEVICE_MAP_STATS (the last
# two only on the v1 path)
MAP_KEYS = ("v2", "total_reads", "overflow_reads", "tier2_reads", "host_map_s",
            "index_entries", "v1_setup_s")

# what made the rows with hashes: the JAX script with every leg on the
# host, so its output does not depend on an accelerator
_MADE_BY = ("JAX_PLATFORMS=cpu python scripts/scale_run.py {mb} 12 OUT 30 --host "
            "(the JAX package), on an 8-core x86-64 CPU without an accelerator")


def _row(mb: str, stats: tuple[int, int, int, int], sha: tuple[str, str, str, str]) -> dict:
    return {
        "coverage": 12.0, "illu_cov": 30.0,
        "stats": dict(zip(("contigs", "total", "n50", "longest"), stats)),
        "sha256": dict(zip((*INPUTS, ASSEMBLY), sha)),
        "made_by": _MADE_BY.format(mb=mb),
    }


SCALE_ROWS: dict[float, dict] = {
    0.25: _row("0.25", (1, 249_208, 249_208, 249_208), (
        "54ec57ac6faf043b76b086f3cb44f98da35fed1870c8a17b46b7a7db57754c2d",
        "8d4377655cc5e888a12a9d819c50988dd6bd6998111d6e9613edc07f0b351f92",
        "0807ef0c176c32ef3ff8c701c7893fbdeca1933193b09c1cc3b385cded32cc26",
        "6866edf15459f8d46395ae9bf123ab19acbe2516cc256559af264042822c2b93")),
    1.0: _row("1", (2, 1_005_713, 748_940, 748_940), (
        "d3702c6fb26ccb5a3b7c0ef0ab9a7e1880544903f930ad42fe63be78131ee423",
        "142cbd8dc2fe4c086e5d6c7fae532313c03486fd4ba6d85a7d46e88ef8da3fd2",
        "c07003a2d2bcf71259c636e543566d1b088d702f7bcf2d738a65c0c20de3689a",
        "a6212f0f20cfc364aa3ce96355e8ed07ae4b1072682959d02ed61b7857330a8d")),
    12.0: _row("12", (8, 12_067_724, 2_236_511, 3_893_904), (
        "0569c598e60c23bdbcefffacd120528f5b21da90c6628576f6e2a19580fd76fd",
        "e9bd1208c684985003819f7ec81d1824eb11c480c99d0e3bbc95d8e8531543be",
        "04506a634d799e518b1f8846202a41c5ce1892bf26672975e49ee933bf98755b",
        "fa27f0f814a8019fdb6354e86223f27a0e14136df087cd765012d9f29f0705ce")),
    40.0: _row("40", (23, 40_192_610, 3_126_076, 5_852_262), (
        "d0e462bcf609b151fe12bd7b1e581520755f41b7632362c2a62d31384bbd9cb9",
        "f0415e7e93949375c5106bb603884823920d12ebb2c1bf6ccd5bc8e69c10bbe9",
        "6af910198b0c8e55c42aae315e27b945bede725337aab72a4da11e223fa7fe21",
        "e0c9ce9de428ce2a0fcf644ae96df2b8671e9e3313fd50d595216a7d31729f31")),
    140.0: _row("140", (79, 140_649_877, 3_097_212, 8_479_572), (
        "9c3b7110c375d7f9bf43b104fea1da5eabd9af4d8a3d47e1e896d1b24f18aa01",
        "8ca2a7123e7c739b2820ff2e96cd23eac8df1345e8aca955eebc069c10ad1bed",
        "98c5b258d2a94f3fa40033058d446d47ddd931d51334c1507ca38d96daa6757e",
        "a951e9d7fb222903eef009b16fe4fefb56f438d8bef29825913af79d04196258")),
}


def make_scale_inputs(out: str | Path, genome_mb: float, coverage: float = 12.0,
                      illu_cov: float = 30.0) -> dict[str, Path]:
    """Write ``nanopore.fa``, ``illu1.fa`` and ``illu2.fa`` into ``out``,
    byte-identical to ``scripts/scale_run.py``'s at the same arguments;
    returns their paths by file name."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(1234)
    sim = simulate(
        rng,
        genome_length=int(genome_mb * 1e6),
        coverage=coverage,
        read_length=9_000,
        unitig_length=1_000,
        unitig_gap=300,
    )

    def noisy_reads():
        for name, seq in sim.read_records():
            seq = add_noise(rng, seq, 0.07)
            # a fifth of the reads get a junk (random-sequence) tail, as
            # real nanopore data has adapter and chimeric ends to scrub
            if rng.random() < 0.2:
                tail = random_genome(rng, int(rng.integers(200, 1500)))
                seq = seq + tail if rng.random() < 0.5 else tail + seq
            yield name, seq

    paths = {name: out / name for name in INPUTS}
    write_fasta(paths["nanopore.fa"], noisy_reads())
    pairs = illumina_pairs(rng, sim.genome, coverage=illu_cov)
    write_fasta(paths["illu1.fa"], ((f"p{i}/1", a) for i, (a, b) in enumerate(pairs)))
    write_fasta(paths["illu2.fa"], ((f"p{i}/2", b) for i, (a, b) in enumerate(pairs)))
    return paths


def contig_stats(fasta: str | Path) -> dict[str, int]:
    """Contigs, total bases, N50 and longest contig of a FASTA file, as
    ``scripts/scale_run.py`` counts them: a record of no bases is no contig,
    and N50 is the first length, longest first, at which the running sum
    reaches half the total."""
    lens = []
    cur = 0
    with open(fasta) as fh:
        for line in fh:
            if line.startswith(">"):
                if cur:
                    lens.append(cur)
                cur = 0
            else:
                cur += len(line.strip())
    if cur:
        lens.append(cur)
    lens.sort(reverse=True)
    tot = sum(lens)
    acc, n50 = 0, 0
    for length in lens:
        acc += length
        if acc >= tot / 2:
            n50 = length
            break
    return {"contigs": len(lens), "total": tot, "n50": n50,
            "longest": lens[0] if lens else 0}


def stats_line(stats: dict[str, int]) -> str:
    """The statistics as the JAX script's ``[scale_run] contigs=`` line
    prints them, without its tag."""
    return (f"contigs={stats['contigs']} total={stats['total']/1e6:.2f}Mb "
            f"N50={stats['n50']/1e6:.2f}Mb longest={stats['longest']/1e6:.2f}Mb")


def sha256(path: str | Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def scale_row(genome_mb: float, coverage: float, illu_cov: float) -> dict | None:
    """The row of ``SCALE_ROWS`` made at these arguments, or None."""
    row = SCALE_ROWS.get(float(genome_mb))
    if row is None or (row["coverage"], row["illu_cov"]) != (coverage, illu_cov):
        return None
    return row


@contextlib.contextmanager
def _cuda_peak(on_card: bool):
    """``max_memory_allocated`` over the block, in ``peak["bytes"]``: the
    core resets the peak for its own memory block, so each reset's peak is
    kept before it drops (None on the CPU)."""
    peak = {"bytes": None}
    if not on_card:
        yield peak
        return
    reset = torch.cuda.reset_peak_memory_stats
    seen = [0]

    def keep_then_reset(device=None):
        seen.append(torch.cuda.max_memory_allocated(device))
        reset(device)

    reset()
    torch.cuda.reset_peak_memory_stats = keep_then_reset
    try:
        yield peak
    finally:
        torch.cuda.reset_peak_memory_stats = reset
        peak["bytes"] = max(seen + [torch.cuda.max_memory_allocated()])


def run_scale_row(out: str | Path, genome_mb: float, coverage: float = 12.0,
                  illu_cov: float = 30.0, *, device: str | torch.device, host: bool = False,
                  keep_batches: list | None = None, log=print, config=None) -> dict:
    """Write a row's inputs into ``out`` and run the port's ``full`` on them
    into ``out/full_out`` with ``config`` (default ``Config()``, as
    ``scripts/scale_run.py`` runs the JAX package's); ``log`` gets that script's ``[scale_run]``
    lines.  ``host`` puts the k-mer, DBG, scrub and mapping legs on the
    host, as its ``--host`` does; otherwise they follow ``device`` (on the
    card, on; on the CPU, the map stages on the CPU's device mapper, the
    other legs on the host).  Where ``keep_batches`` is a list, a host copy
    of every packed batch the core hands ``chain_dp`` is appended to it as
    ``([fields, flags, offsets], K, wiggle_room)``.

    Returns the run's record: stage walls, contig statistics, the four
    sha256 values and, where ``SCALE_ROWS`` has the row, whether each
    equals it (``equal``), peak CUDA memory, the device legs' counters,
    each map stage's ``MAP_KEYS``, the core's chaining counters,
    ``chain_dp`` launches and the process's peak resident memory."""
    from muchsalsa_tpu_torch.config import Config
    from muchsalsa_tpu_torch.device import resolve_device
    from muchsalsa_tpu_torch.ops import chaining_torch
    from muchsalsa_tpu_torch.ops.chain_scan import chain_dp
    from muchsalsa_tpu_torch.ops.dbg_torch import DBG_DEVICE_STATS
    from muchsalsa_tpu_torch.ops.kmer_torch import KMER_DEVICE_STATS
    from muchsalsa_tpu_torch.pipeline.full import MAP_STAGE_STATS, run_full_pipeline
    from muchsalsa_tpu_torch.pipeline.mapper_torch import DEVICE_MAP_STATS_CUM
    from muchsalsa_tpu_torch.pipeline.scrubber import SCRUB_DEVICE_STATS

    dev = resolve_device(device)
    out = Path(out)
    t0 = time.perf_counter()
    inputs = make_scale_inputs(out, genome_mb, coverage, illu_cov)
    simulation_s = time.perf_counter() - t0
    log(f"[scale_run] simulation written in {simulation_s:.1f}s")

    # None leaves a leg to the device, as the JAX script's auto placement
    legs = {"device_map": not host, **dict.fromkeys(
        ("device_kmer", "device_scrub", "device_dbg"), False if host else None)}
    for stats in (KMER_DEVICE_STATS, DBG_DEVICE_STATS, SCRUB_DEVICE_STATS,
                  DEVICE_MAP_STATS_CUM):
        stats.clear()
    if keep_batches is not None:
        def keep_batch(fields, flags, offsets, K, wiggle_room):
            keep_batches.append(([x.cpu() for x in (fields, flags, offsets)], K, wiggle_room))
            return chain_dp(fields, flags, offsets, K, wiggle_room)

        chaining_torch.chain_dp = keep_batch
    chain_dp.launches = 0
    full_out = out / "full_out"
    try:
        with _cuda_peak(dev.type == "cuda") as peak:
            t0 = time.perf_counter()
            final = run_full_pipeline(inputs["illu1.fa"], inputs["illu2.fa"],
                                      inputs["nanopore.fa"], full_out,
                                      config or Config(), device=dev, **legs)
            full_s = time.perf_counter() - t0
    finally:
        chaining_torch.chain_dp = chain_dp
    launches = chain_dp.launches
    log(f"[scale_run] full pipeline: {full_s:.1f}s")
    stats = contig_stats(final)
    log(f"[scale_run] {stats_line(stats)}")

    manifest = json.loads((full_out / "manifest.json").read_text())
    core = json.loads((full_out / "core" / "assembly_stats.json").read_text())
    sha = {name: sha256(path) for name, path in inputs.items()}
    sha[ASSEMBLY] = sha256(final)
    row = scale_row(genome_mb, coverage, illu_cov)
    equal = {}
    if row is not None:
        equal = {name: sha[name] == want for name, want in row.get("sha256", {}).items()}
        equal["stats"] = stats == row["stats"]
    return {
        "genome_mb": genome_mb, "coverage": coverage, "illu_cov": illu_cov,
        "device": str(dev), "placement": legs,
        "simulation_s": simulation_s, "full_s": full_s,
        "stages_s": {name: entry["elapsed_s"] for name, entry in manifest.items()},
        "core_stages_s": core["stages"],
        "stats": stats, "sha256": sha, "row": row is not None, "equal": equal,
        "cuda_peak_bytes": peak["bytes"],
        "core_cuda_peak_bytes": core["memory"].get("device_peak_bytes_allocated"),
        "kmer": dict(KMER_DEVICE_STATS), "dbg": dict(DBG_DEVICE_STATS),
        "scrub": dict(SCRUB_DEVICE_STATS),
        "map": {name: {k: st.get(k) for k in MAP_KEYS} for name, st in MAP_STAGE_STATS.items()},
        "map_cum": dict(DEVICE_MAP_STATS_CUM),
        "chain": {k: v for k, v in core["counters"].items() if k.startswith("chain")},
        "chain_dp_launches": launches,
        # ru_maxrss is in KiB on Linux
        "peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss << 10,
    }
