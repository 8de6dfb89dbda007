"""The full pipeline on a torch device: raw reads -> unpolished assembly.

Port of ``muchsalsa_tpu/pipeline/full.py::run_full_pipeline`` (:103-325):

  ① k-mer filter of the Illumina reads     ``ops/kmer_torch.py`` counts, or host
  ② unitigs                                ``ops/dbg_torch.py`` extensions, or host
  ③ map unitigs onto the long reads        the port's ``map_all``
  ④ unitig coverage filter                 host (``pipeline/unitig_filter.py``)
  ⑤ map the corrected unitigs              the port's ``map_all``
  ⑥ scrub the long reads                   ``pipeline/scrubber.py``, all-vs-all
                                           on the device mapper, or host
  ⑦ map onto the scrubbed reads            the port's ``map_all``
  ⑧ core assembly                          the port's ``assemble``
  ⑨ copy the target contigs to ``03.assembly.unpolished.fa``

Stages ③⑤⑦ map on ``device`` when ``device_map`` is set (else on the host)
and refine on ``device`` when ``config.mapper.refine`` is set; stages ①②⑥
run their device legs on ``device`` when ``device_kmer``, ``device_dbg``
and ``device_scrub`` are set; stage ⑧ runs edges and chaining on
``device``.  The rest is host code, the port's own copy of the JAX
package's modules.  Stages checkpoint through ``StageRunner`` manifests (a
rerun skips what is up to date; the manifest keys do not hold the
placement, as in the JAX package).
"""

from __future__ import annotations

import shutil
from pathlib import Path

import torch

from muchsalsa_tpu_torch.config import DEFAULT_CONFIG, Config
from muchsalsa_tpu_torch.device import resolve_device
from muchsalsa_tpu_torch.io.fasta import SequenceStore, write_fasta
from muchsalsa_tpu_torch.pipeline.stages import StageRunner

SENTINEL = "__sentinel__\t1\t0\t1\t+\t__sentinel__\t1\t0\t1\t0\t1\t0"

# the last run's DEVICE_MAP_STATS of each map stage that mapped on the
# device, by the stage's PAF name
MAP_STAGE_STATS: dict[str, dict] = {}


def _read_pairs(path1: Path, path2: Path | None):
    """Illumina mates as (R1, R2) byte pairs, R2 empty where the second file
    is shorter or absent (``muchsalsa_tpu/pipeline/full.py:91``)."""
    s1 = SequenceStore.from_file(path1)
    seqs1 = [s1.sequence(i) for i in s1.ids()]
    if path2 is None:
        return [(s, b"") for s in seqs1]
    s2 = SequenceStore.from_file(path2)
    seqs2 = [s2.sequence(i) for i in s2.ids()]
    if len(seqs2) < len(seqs1):
        seqs2 += [b""] * (len(seqs1) - len(seqs2))
    return list(zip(seqs1, seqs2))


def run_full_pipeline(
    illumina1: str | Path,
    illumina2: str | Path | None,
    nanopore: str | Path,
    outdir: str | Path,
    config: Config = DEFAULT_CONFIG,
    kmer_filter_k: int | None = None,
    unitig_k: int = 31,
    device: str | torch.device = "cuda",
    device_map: bool = True,
    device_kmer: bool | None = None,
    device_scrub: bool | None = None,
    device_dbg: bool | None = None,
) -> Path:
    """Run the pipeline into ``outdir``; returns the final assembly's path.

    ``device`` (default ``cuda``, which raises without a card) is where the
    map stages' device mapping and refinement, the device legs of stages
    ①②⑥ and the core's edges and chaining run; ``device_map=False`` maps
    on the host instead.  ``device_kmer``, ``device_dbg`` and
    ``device_scrub`` put their legs on ``device`` when True and on the host
    when False; None (the default) means on where ``device`` is a card and
    off on the CPU, as the JAX package's ``auto`` with an accelerator
    attached, but only where the leg's k fits its 64-bit packing (k <= 31).
    ``report.txt`` states each leg's placement.
    """
    dev = resolve_device(device)
    k_filter = kmer_filter_k or config.pipeline.kmer_k_filter
    on_card = dev.type == "cuda"
    device_kmer = (on_card and k_filter <= 31) if device_kmer is None else device_kmer
    device_dbg = (on_card and unitig_k <= 31) if device_dbg is None else device_dbg
    device_scrub = on_card if device_scrub is None else device_scrub

    MAP_STAGE_STATS.clear()
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    runner = StageRunner(out)
    report = out / "report.txt"
    with open(report, "a") as fh:
        fh.write(f"device placement: map={device_map} kmer={device_kmer} "
                 f"scrub={device_scrub} dbg={device_dbg} (torch device {dev})\n")

    illumina1 = Path(illumina1)
    illumina2 = Path(illumina2) if illumina2 else None
    nanopore = Path(nanopore)

    filtered_fa = out / "01_illu_filtered.fa"
    unitigs_fa = out / "01_unitigs.fa"
    paf1 = out / "01_unitigs.paf"
    corrected_fa = out / "01_unitigs_corrected.fa"
    paf2 = out / "01_contigs_corrected.paf"
    scrubbed_fa = out / "02_scrubbed.fa"
    paf3 = out / "02_contigs_corrected.scrubbed.paf"
    core_out = out / "core"
    final_fa = out / "03.assembly.unpolished.fa"

    # ① k-mer filter of Illumina reads
    def stage_kmer():
        from muchsalsa_tpu_torch.pipeline.kmer import (
            abundance_threshold, count_kmers, filter_read_pairs, high_abundance_kmers,
            histogram)

        pairs = _read_pairs(illumina1, illumina2)
        seqs = [s for p in pairs for s in p if s]
        if device_kmer:
            from muchsalsa_tpu_torch.ops.kmer_torch import KMER_DEVICE_STATS, count_kmers_device

            uniq, counts = count_kmers_device(seqs, k_filter, device=dev)
            with open(report, "a") as fh:
                fh.write(f"device kmer: {KMER_DEVICE_STATS['chunks']} chunks, "
                         f"{KMER_DEVICE_STATS['rows']} rows, {KMER_DEVICE_STATS['kmers']} "
                         f"k-mers on {KMER_DEVICE_STATS['device']}\n")
        else:
            uniq, counts = count_kmers(seqs, k_filter)
        th = abundance_threshold(histogram(counts))
        bad = high_abundance_kmers(uniq, counts, max(th, 2))
        kept = filter_read_pairs(pairs, bad, k_filter)
        with open(report, "a") as fh:
            fh.write(f"abundance threshold for k-mer filtering: {th}\n")
            fh.write(f"read pairs kept: {len(kept)}/{len(pairs)}\n")
        records = []
        for i, (a, b) in enumerate(kept):
            records.append((f"pair{i}/1", a))
            if b:
                records.append((f"pair{i}/2", b))
        write_fasta(filtered_fa, records)

    runner.run("kmer_filter", [p for p in (illumina1, illumina2) if p], [filtered_fa],
               stage_kmer, {"k": k_filter})

    # ② unitig construction
    def stage_unitigs():
        from muchsalsa_tpu_torch.pipeline.dbg import build_unitigs

        store = SequenceStore.from_file(filtered_fa)
        unitigs = build_unitigs(
            [store.sequence(i) for i in store.ids()], k=unitig_k, min_count=2,
            min_length=config.pipeline.min_unitig_length,
            device=dev if device_dbg else False)
        if device_dbg:
            from muchsalsa_tpu_torch.ops.dbg_torch import DBG_DEVICE_STATS

            with open(report, "a") as fh:
                fh.write(f"device dbg: {DBG_DEVICE_STATS['rows']} k-mers' extensions in "
                         f"{DBG_DEVICE_STATS['chunks']} chunks on {DBG_DEVICE_STATS['device']}\n")
        write_fasta(unitigs_fa, ((f"unitig_{i}", u) for i, u in enumerate(unitigs)))

    runner.run("unitigs", [filtered_fa], [unitigs_fa], stage_unitigs, {"k": unitig_k})

    # stores load once per path, so the packed read batches that device
    # mapping keeps on a store serve all three map stages
    _stores: dict[Path, SequenceStore] = {}

    def load_store(path: Path) -> SequenceStore:
        store = _stores.get(path)
        if store is None:
            store = _stores[path] = SequenceStore.from_file(path)
        return store

    def map_stage(query_fa: Path, target_fa: Path, out_paf: Path):
        from muchsalsa_tpu_torch.pipeline.mapper_torch import (
            DEVICE_MAP_STATS, MinimizerIndex, map_all, write_paf)

        unitigs = load_store(query_fa)
        reads = load_store(target_fa)
        index = MinimizerIndex.build(unitigs, config.mapper)
        DEVICE_MAP_STATS.clear()
        lines = map_all(
            index, reads, config.mapper,
            unitig_names=lambda u: unitigs.registry.name(u),
            read_names=lambda r: reads.registry.name(r),
            unitigs=unitigs, device=device_map, torch_device=dev)
        if device_map and "total_reads" in DEVICE_MAP_STATS:
            # reads mapped on the host instead: a high rate means the
            # device run quietly became a host run
            MAP_STAGE_STATS[out_paf.name] = dict(DEVICE_MAP_STATS)
            tot = DEVICE_MAP_STATS["total_reads"]
            ovf = DEVICE_MAP_STATS["overflow_reads"]
            with open(report, "a") as fh:
                fh.write(
                    f"device map {out_paf.name}: {tot - ovf}/{tot} reads on device, "
                    f"{ovf} overflow->host ({100.0 * ovf / max(tot, 1):.1f}%), "
                    f"{DEVICE_MAP_STATS['tier2_reads']} through tier 2, "
                    f"v2={DEVICE_MAP_STATS['v2']}\n")
        # the core parser drops the final PAF line by reference parity:
        # terminate with a sentinel so no real mapping is lost
        write_paf(lines + [SENTINEL], out_paf)

    # ③ map unitigs onto long reads
    runner.run("map_unitigs", [unitigs_fa, nanopore], [paf1],
               lambda: map_stage(unitigs_fa, nanopore, paf1))

    # ④ unitig coverage filter
    def stage_unitig_filter():
        from muchsalsa_tpu_torch.pipeline.unitig_filter import filter_unitigs

        store = SequenceStore.from_file(unitigs_fa)
        seqs = {store.registry.name(i): store.sequence(i) for i in store.ids()}
        lines = [ln for ln in paf1.read_text().splitlines() if ln and "__sentinel__" not in ln]
        corrected, stats = filter_unitigs(
            lines, seqs, config.pipeline.unitig_iqr_multiplier,
            config.pipeline.min_unitig_length)
        with open(report, "a") as fh:
            fh.write(">>> unitig filter\n")
            fh.write(f"upper_outlier: {stats.cutoff}\nQ3: {stats.q3}\n")
            fh.write(f"#all unitigs: {stats.all_count}\n#outliers: {stats.outlier_count}\n")
            fh.write(f"#rescued outliers: {stats.rescued_count}\n")
        write_fasta(corrected_fa, corrected)

    runner.run("unitig_filter", [paf1, unitigs_fa], [corrected_fa], stage_unitig_filter)

    # ⑤ re-map corrected unitigs
    runner.run("map_corrected", [corrected_fa, nanopore], [paf2],
               lambda: map_stage(corrected_fa, nanopore, paf2))

    # ⑥ scrub long reads
    def stage_scrub():
        from muchsalsa_tpu_torch.pipeline.scrubber import scrub_reads

        reads = SequenceStore.from_file(nanopore)
        lines = [ln for ln in paf2.read_text().splitlines() if ln and "__sentinel__" not in ln]
        scrubbed = scrub_reads(lines, reads, config.scrub, config.mapper,
                               device=dev if device_scrub else False)
        if device_scrub:
            from muchsalsa_tpu_torch.pipeline.scrubber import SCRUB_DEVICE_STATS as st

            with open(report, "a") as fh:
                mapped = [x for x in st["subsets"] if not x["declined"]]
                fh.write(f"device scrub: {st['on_device']} subsets on {st['device']}, "
                         f"{st['declined']} declined to the host; (multiplicity, chunks): "
                         f"{[(round(x['multiplicity'], 3), x['chunks']) for x in st['subsets']]}; "
                         f"reads {sum(x['total_reads'] for x in mapped)}, "
                         f"{sum(x['overflow_reads'] for x in mapped)} overflow->host, "
                         f"{sum(x['tier2_reads'] for x in mapped)} through tier 2\n")
        write_fasta(scrubbed_fa, scrubbed)

    runner.run("scrub", [paf2, nanopore], [scrubbed_fa], stage_scrub)

    # ⑦ map corrected unitigs onto scrubbed reads
    runner.run("map_scrubbed", [corrected_fa, scrubbed_fa], [paf3],
               lambda: map_stage(corrected_fa, scrubbed_fa, paf3))

    # mapping stages done: release the stores and their device batches
    _stores.clear()

    # ⑧ core assembly
    def stage_core():
        from muchsalsa_tpu_torch.assemble.driver import assemble

        assemble(paf3, corrected_fa, scrubbed_fa, core_out, config, device=dev)

    runner.run("core_assembly", [paf3, corrected_fa, scrubbed_fa],
               [core_out / "temp_1.target.fa"], stage_core)

    # ⑨ final copy (pipeline.sh:181)
    shutil.copyfile(core_out / "temp_1.target.fa", final_fa)
    return final_fa
