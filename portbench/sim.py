"""The inputs of a map-stage job, made from the seed.

The genome is random.  Its unitigs tile it as the DBG leg of ``full``
(``pipeline/dbg.py::build_unitigs``, k 31) tiles a scale row's genome:
``unitig_min_length`` plus an exponential length of mean
``unitig_mean_length - unitig_min_length``, an exponential gap of mean
``unitig_gap_mean`` before each, either strand.  The long reads follow the
scale rows' read model (``scripts/scale_run.py`` and
``muchsalsa_tpu_torch/testing/simulate.py``), vectorised: ``read_length``
plus a jitter drawn from [-``read_length_jitter``, ``read_length_jitter``),
taken from either strand, with noise at ``error_rate`` in equal parts
substitution, insertion and deletion; a fraction ``tail_fraction`` of them
with a tail of random bases, ``tail_min`` to ``tail_max`` long, at either
end.  The distributions are the scale rows', not their bytes.

The sizes are the same for every seed: each unitig's place and length and
each read's length and tail are drawn once from the configuration's
``shape_seed``, and the seed only orders the reads and makes the bases
(genome, unitig strands, read positions and strands, noise, tails).  A
read's noisy body is cut to its drawn length, so noise moves no read into
another length bucket.  The bases are made on ``device`` with a
``torch.Generator`` in large calls, then come to the host once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)
SLACK = 400          # bases taken past a read's length, so its noisy body is never short
CHUNK_BASES = 1 << 25  # genome bases gathered at once while making reads


@dataclass
class Inputs:
    """Codes (0-3) of the unitigs and reads, concatenated, with offsets."""

    unitig_codes: np.ndarray
    unitig_offsets: np.ndarray
    read_codes: np.ndarray
    read_offsets: np.ndarray

    @property
    def n_reads(self) -> int:
        return len(self.read_offsets) - 1

    @property
    def n_unitigs(self) -> int:
        return len(self.unitig_offsets) - 1

    def unitig_records(self) -> list[tuple[str, bytes]]:
        return _records("unitig", self.unitig_codes, self.unitig_offsets)

    def read_records(self) -> list[tuple[str, bytes]]:
        return _records("read", self.read_codes, self.read_offsets)


def _records(prefix, codes, offsets) -> list[tuple[str, bytes]]:
    blob = ASCII[codes].tobytes()
    return [(f"{prefix}_{i}", blob[offsets[i] : offsets[i + 1]])
            for i in range(len(offsets) - 1)]


def unitig_layout(config: dict) -> tuple[np.ndarray, np.ndarray]:
    """(start, length) of every unitig on the genome, from the
    configuration's ``shape_seed`` alone: gap, unitig, gap, unitig, ... while
    a whole unitig fits."""
    rng = np.random.default_rng([config["shape_seed"], 1])
    G = int(config["genome_length"])
    lo = int(config["unitig_min_length"])
    step = config["unitig_mean_length"] + config["unitig_gap_mean"]
    n = int(1.5 * G / step) + 64
    length = lo + rng.exponential(config["unitig_mean_length"] - lo, n).astype(np.int64)
    gap = rng.exponential(config["unitig_gap_mean"], n).astype(np.int64)
    end = np.cumsum(gap + length)
    keep = end <= G
    if keep.all():
        raise ValueError("the unitig draw did not reach the genome's end")
    return (end - length)[keep], length[keep]


def read_shapes(config: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(body length, tail length, tail in front) of every read, from the
    configuration's ``shape_seed`` alone."""
    rng = np.random.default_rng(config["shape_seed"])
    n = config["job_reads"]
    jit = config["read_length_jitter"]
    body = config["read_length"] + rng.integers(-jit, jit, n) if jit else np.full(
        n, config["read_length"])
    tailed = rng.random(n) < config["tail_fraction"]
    tail = np.where(tailed, rng.integers(config["tail_min"], config["tail_max"], n), 0)
    front = rng.random(n) < 0.5
    return body.astype(np.int64), tail.astype(np.int64), front


def make_inputs(config: dict, seed: int, device) -> Inputs:
    """Genome, unitigs and reads of one cell for ``seed`` on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    G = int(config["genome_length"])
    genome = torch.randint(0, 4, (G,), generator=gen, device=dev, dtype=torch.uint8)

    starts, lengths = unitig_layout(config)
    unitig_codes = _unitig_codes(genome, starts, lengths, gen)
    unitig_offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=unitig_offsets[1:])

    body, tail, front = read_shapes(config)
    order = torch.randperm(len(body), generator=gen, device=dev).cpu().numpy()
    body, tail, front = body[order], tail[order], front[order]
    span = body + SLACK
    if int(span.max(initial=0)) > G:
        raise ValueError(f"a read of {int(span.max())} bases does not fit a genome of {G}")
    n = len(body)
    pos = (torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
           * torch.from_numpy(G - span + 1).to(dev)).long().clamp(max=G - 1)
    forward = torch.rand(n, generator=gen, device=dev) < 0.5

    read_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(body + tail, out=read_offsets[1:])
    read_codes = np.empty(int(read_offsets[-1]), dtype=np.uint8)
    lo = 0
    while lo < n:
        hi = lo + 1
        total = int(span[lo])
        while hi < n and total + span[hi] <= CHUNK_BASES:
            total += int(span[hi])
            hi += 1
        chunk = _noisy_reads(genome, pos[lo:hi], forward[lo:hi], span[lo:hi], body[lo:hi],
                             tail[lo:hi], front[lo:hi], config["error_rate"], gen)
        read_codes[read_offsets[lo] : read_offsets[hi]] = chunk
        lo = hi
    return Inputs(unitig_codes, unitig_offsets, read_codes, read_offsets)


def _unitig_codes(genome, starts, lengths, gen) -> np.ndarray:
    """Codes of the unitigs, end to end, each read off the genome on a
    strand drawn from ``gen``."""
    dev = genome.device
    start_t = torch.from_numpy(starts).to(dev)
    len_t = torch.from_numpy(lengths).to(dev)
    minus = torch.rand(len(starts), generator=gen, device=dev) < 0.5
    uid = torch.repeat_interleave(torch.arange(len(starts), device=dev), len_t)
    j = torch.arange(int(lengths.sum()), device=dev) - (torch.cumsum(len_t, 0) - len_t)[uid]
    rev = minus[uid]
    src = torch.where(rev, start_t[uid] + len_t[uid] - 1 - j, start_t[uid] + j)
    del j
    codes = genome[src]
    return torch.where(rev, 3 - codes, codes).cpu().numpy()


def _noisy_reads(genome, pos, forward, span, body, tail, front, error_rate, gen) -> np.ndarray:
    """Codes of a run of reads, each its noisy body with its tail, end to
    end."""
    dev = genome.device
    span_t = torch.from_numpy(span).to(dev)
    n_in = int(span.sum())
    read_of = torch.repeat_interleave(torch.arange(len(span), device=dev), span_t)
    first = torch.cumsum(span_t, 0) - span_t
    j = torch.arange(n_in, device=dev) - first[read_of]
    fwd = forward[read_of]
    src = torch.where(fwd, pos[read_of] + j, pos[read_of] + span_t[read_of] - 1 - j)
    raw = genome[src]
    raw = torch.where(fwd, raw, 3 - raw)

    r = torch.rand(n_in, generator=gen, device=dev)
    third = error_rate / 3
    deleted = r < third
    subbed = (r >= third) & (r < 2 * third)
    inserted = (r >= 2 * third) & (r < error_rate)
    sub_base = torch.randint(0, 4, (n_in,), generator=gen, device=dev, dtype=torch.uint8)
    ins_base = torch.randint(0, 4, (n_in,), generator=gen, device=dev, dtype=torch.uint8)
    counts = torch.where(deleted, 0, torch.where(inserted, 2, 1))
    offs = torch.cumsum(counts, 0) - counts
    out = torch.empty(int(counts.sum()), dtype=torch.uint8, device=dev)
    kept = ~deleted
    out[offs[kept]] = torch.where(subbed, sub_base, raw)[kept]
    out[offs[inserted] + 1] = ins_base[inserted]

    # each read's noisy body starts where its first base's output does
    noisy_len = torch.zeros(len(span), dtype=torch.long, device=dev).index_add_(0, read_of, counts)
    body_t = torch.from_numpy(body).to(dev)
    if bool((noisy_len < body_t).any()):
        raise ValueError("a noisy read came out shorter than its drawn length")
    out_first = offs[first]

    tail_t = torch.from_numpy(tail).to(dev)
    tail_bases = torch.randint(0, 4, (int(tail.sum()),), generator=gen, device=dev,
                               dtype=torch.uint8)
    length = body_t + tail_t
    n_out = int(length.sum())
    rid = torch.repeat_interleave(torch.arange(len(span), device=dev), length)
    start = torch.cumsum(length, 0) - length
    k = torch.arange(n_out, device=dev) - start[rid]
    front_t = torch.from_numpy(front).to(dev)[rid]
    tail_first = torch.cumsum(tail_t, 0) - tail_t
    in_tail = torch.where(front_t, k < tail_t[rid], k >= body_t[rid])
    body_k = torch.where(front_t, k - tail_t[rid], k)
    tail_k = torch.where(front_t, k, k - body_t[rid])
    from_body = out[(out_first[rid] + body_k.clamp(min=0)).clamp(max=len(out) - 1)]
    if len(tail_bases):
        from_tail = tail_bases[(tail_first[rid] + tail_k.clamp(min=0)).clamp(
            max=len(tail_bases) - 1)]
    else:
        from_tail = from_body
    return torch.where(in_tail, from_tail, from_body).cpu().numpy()
