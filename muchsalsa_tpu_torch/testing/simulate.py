"""Ground-truth data simulator for end-to-end tests and benchmarks.

The reference ships no PAF fixtures and leaves its kernels untested
(SURVEY.md §4); this simulator closes that gap: it generates a random
genome, exact "unitigs" (the Illumina-accurate anchors the real pipeline
gets from ABySS), noisy/exact long reads, and a ground-truth PAF of
unitig->read mappings matching the column contract parsed by
``BlastFileReader`` (query = unitig, target = nanopore read).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from muchsalsa_tpu_torch.utils.seq import reverse_complement

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_genome(rng: np.random.Generator, length: int) -> bytes:
    return _BASES[rng.integers(0, 4, size=length)].tobytes()


@dataclass
class SimulatedAssembly:
    genome: bytes
    unitigs: list[tuple[str, int, int]]          # (name, start, end_excl)
    reads: list[tuple[str, int, int, bool]]      # (name, start, end_excl, forward)
    paf_lines: list[str] = field(default_factory=list)

    def unitig_records(self):
        for name, s, e in self.unitigs:
            yield name, self.genome[s:e]

    def read_records(self):
        for name, s, e, fwd in self.reads:
            seq = self.genome[s:e]
            yield name, seq if fwd else reverse_complement(seq)


def simulate(
    rng: np.random.Generator,
    genome_length: int = 20_000,
    unitig_length: int = 1_000,
    unitig_gap: int = 300,
    read_length: int = 4_000,
    coverage: float = 8.0,
    min_overlap: int = 500,
    both_strands: bool = True,
) -> SimulatedAssembly:
    genome = random_genome(rng, genome_length)

    unitigs = []
    pos = 0
    idx = 0
    while pos + unitig_length <= genome_length:
        unitigs.append((f"unitig_{idx}", pos, pos + unitig_length))
        pos += unitig_length + unitig_gap
        idx += 1

    n_reads = max(2, int(coverage * genome_length / read_length))
    reads = []
    for r in range(n_reads):
        start = int(rng.integers(0, max(1, genome_length - read_length)))
        end = min(genome_length, start + read_length + int(rng.integers(-200, 200)))
        fwd = bool(rng.integers(0, 2)) if both_strands else True
        reads.append((f"read_{r}", start, end, fwd))

    sim = SimulatedAssembly(genome, unitigs, reads)
    sim.paf_lines = _ground_truth_paf(sim, min_overlap)
    return sim


def add_noise(rng: np.random.Generator, seq: bytes, error_rate: float) -> bytes:
    """Nanopore-style noise: equal parts substitution/insertion/deletion
    (vectorised)."""
    if error_rate <= 0:
        return seq
    arr = np.frombuffer(seq, dtype=np.uint8)
    n = len(arr)
    r = rng.random(n)
    third = error_rate / 3
    deleted = r < third
    subbed = (r >= third) & (r < 2 * third)
    inserted = (r >= 2 * third) & (r < error_rate)

    sub_base = _BASES[rng.integers(0, 4, n)]
    ins_base = _BASES[rng.integers(0, 4, n)]

    counts = np.where(deleted, 0, np.where(inserted, 2, 1))
    offsets = np.cumsum(counts) - counts
    out = np.empty(int(counts.sum()), dtype=np.uint8)
    kept = ~deleted
    out[offsets[kept]] = np.where(subbed, sub_base, arr)[kept]
    out[offsets[inserted] + 1] = ins_base[inserted]
    return out.tobytes()


def illumina_pairs(
    rng: np.random.Generator,
    genome: bytes,
    coverage: float = 30.0,
    read_length: int = 150,
    insert: int = 350,
) -> list[tuple[bytes, bytes]]:
    """Error-free paired short reads (R2 is the reverse complement of the
    insert's far end, like real FR pairs)."""
    n_pairs = max(1, int(coverage * len(genome) / (2 * read_length)))
    pairs = []
    hi = max(1, len(genome) - insert)
    for _ in range(n_pairs):
        start = int(rng.integers(0, hi))
        frag = genome[start : start + insert]
        r1 = frag[:read_length]
        r2 = reverse_complement(frag[-read_length:])
        pairs.append((r1, r2))
    return pairs


def _ground_truth_paf(sim: SimulatedAssembly, min_overlap: int) -> list[str]:
    """Truth overlaps, vectorised: per unitig, candidate reads come from
    a searchsorted window over start-sorted reads (the naive double loop
    is O(U*R) — ~2e10 iterations at 140 Mb)."""
    lines = []
    if not sim.reads:
        return lines
    rs_a = np.array([r[1] for r in sim.reads])
    re_a = np.array([r[2] for r in sim.reads])
    order = np.argsort(rs_a, kind="stable")
    rs_s, re_s = rs_a[order], re_a[order]
    max_rl = int(np.max(re_a - rs_a))

    for uname, us, ue in sim.unitigs:
        w0 = np.searchsorted(rs_s, us + min_overlap - max_rl, side="left")
        w1 = np.searchsorted(rs_s, ue - min_overlap, side="right")
        cand = order[w0:w1]
        lo_a = np.maximum(us, rs_a[cand])
        hi_a = np.minimum(ue, re_a[cand])
        hits = np.sort(cand[hi_a - lo_a >= min_overlap])  # original read order
        for ri in hits:
            rname, rs, re_, fwd = sim.reads[ri]
            lo = max(us, rs)
            hi = min(ue, re_)
            ulen = ue - us
            rlen = re_ - rs
            q_start = lo - us
            q_end = hi - us            # exclusive, PAF convention
            if fwd:
                t_start = lo - rs
                t_end = hi - rs
                strand = "+"
            else:
                t_start = re_ - hi
                t_end = re_ - lo
                strand = "-"
            matches = hi - lo
            lines.append(
                f"{uname}\t{ulen}\t{q_start}\t{q_end}\t{strand}\t{rname}\t{rlen}"
                f"\t{t_start}\t{t_end}\t{matches}\t{matches}\t60"
            )
    return lines


def write_simulation(sim: SimulatedAssembly, outdir: str | Path) -> dict[str, Path]:
    """Write unitigs.fa, reads.fa, truth.paf into ``outdir``."""
    from muchsalsa_tpu_torch.io.fasta import write_fasta

    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    paths = {
        "unitigs": outdir / "unitigs.fa",
        "reads": outdir / "reads.fa",
        "paf": outdir / "truth.paf",
        "genome": outdir / "genome.fa",
    }
    write_fasta(paths["unitigs"], sim.unitig_records())
    write_fasta(paths["reads"], sim.read_records())
    write_fasta(paths["genome"], [("genome", sim.genome)])
    # append a sentinel last line: the reference reader always drops the
    # final PAF line, so real content must not live there
    lines = sim.paf_lines + ["sentinel\t1\t0\t1\t+\tsentinel\t1\t0\t1\t0\t1\t0"]
    paths["paf"].write_text("\n".join(lines) + "\n")
    return paths
