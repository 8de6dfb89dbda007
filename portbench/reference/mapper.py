"""A plain minimizer mapper: the semantics of the port's host mapper,
written again in plain PyTorch and run on whatever device it is given.

What it computes, for a query set (unitigs) and a target set (reads):

1. Every k-mer of a sequence is packed big-endian in 2 bits a base
   (A, C, G, T = 0..3; any other base makes the k-mer invalid), with its
   reverse complement packed the same way.  Its canonical value is the
   smaller of the two, its strand True where the forward one is not larger,
   and its hash murmur3's 32-bit finalizer of the canonical value.  An
   invalid k-mer hashes to 2**32 - 1.
2. A sequence's minimizers are, for each window of ``w`` consecutive k-mers,
   the leftmost k-mer of least hash (one window over all k-mers where there
   are at most ``w``), without repeats, invalid k-mers left out.
3. The index holds every unitig minimizer (hash, unitig, position, strand);
   a hash held more than ``max_occ`` times is dropped.  (A control keys the
   index on the hash's top ``key_bits`` bits alone; the mapper keys on all
   32.)
4. A read's anchors are its minimizers found in the index, one per index
   entry: (unitig, relative strand = entry strand == read strand, unitig
   position q, read position t).  Anchors of one (unitig, relative strand)
   sorted by diagonal (t - q on the same strand, t + q on the other) form one
   chain while consecutive diagonals differ by at most ``bandwidth``.
5. A chain's matches are the read bases covered by its anchors' k-mers; it
   is a mapping when it has ``min_anchor_count`` anchors and
   ``min_chain_score`` matches.  Its coordinates are the least and largest
   anchor positions, the ends plus k.  A read's mappings come in order of
   (unitig, relative strand), then diagonal.

This file imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
UNCHECKED = -1   # matches that a refined job's check leaves out: a PAF line reads ``*``


@dataclass
class Params:
    k: int = 15
    w: int = 5
    max_occ: int = 64
    bandwidth: int = 2000
    min_anchor_count: int = 3
    min_chain_score: int = 100
    key_bits: int = 32   # bits of the hash that the index keys on: below 32 only in a control


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` modulo 2**32 for int64 ``x`` below 2**32, with no
    product past 2**49."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def sketch(codes: torch.Tensor, offsets: torch.Tensor, p: Params):
    """Minimizers of every sequence of a concatenation: ``codes`` (T,)
    uint8, sequence s at ``offsets[s]:offsets[s+1]``.  Returns (sequence,
    position in it, hash, strand) of each minimizer, by sequence and then
    position."""
    dev = codes.device
    T = codes.numel()
    k, w = p.k, p.w
    lens = offsets[1:] - offsets[:-1]
    n_kmers = (lens - k + 1).clamp(min=0)
    if T < k or int(n_kmers.sum()) == 0:
        z = torch.zeros(0, dtype=torch.long, device=dev)
        return z, z, z, torch.zeros(0, dtype=torch.bool, device=dev)
    c = codes.long()
    L = T - k + 1
    fwd = torch.zeros(L, dtype=torch.long, device=dev)
    rc = torch.zeros(L, dtype=torch.long, device=dev)
    bad = torch.zeros(L, dtype=torch.bool, device=dev)
    for j in range(k):
        col = c[j : j + L]
        fwd = (fwd << 2) | (col & 3)
        rc = rc | (((3 - col) & 3) << (2 * j))
        bad |= col >= 4
    h = torch.where(bad, MASK32, fmix32(torch.minimum(fwd, rc)))
    strand = fwd <= rc

    seq_of = torch.repeat_interleave(torch.arange(len(lens), device=dev), lens)[:L]
    start = offsets[:-1][seq_of]
    last = start + n_kmers[seq_of] - 1          # the sequence's last k-mer start
    hp = torch.cat([h, torch.full((w,), MASK32 + 1, dtype=torch.long, device=dev)])
    m = hp[:L]
    for j in range(1, w):
        m = torch.minimum(m, hp[j : j + L])
    local = torch.full((L,), w - 1, dtype=torch.long, device=dev)
    for j in range(w - 1, -1, -1):
        local = torch.where(hp[j : j + L] == m, j, local)
    p0 = torch.arange(L, device=dev)
    window = p0 + (w - 1) <= last                # a whole window inside the sequence
    chosen = torch.zeros(L, dtype=torch.bool, device=dev)
    chosen[(p0 + local)[window]] = True
    # a sequence of at most w k-mers has one window over all of them
    short = torch.nonzero((n_kmers > 0) & (n_kmers <= w)).flatten().tolist()
    for s in short:
        a = int(offsets[s])
        chosen[a + int(torch.argmin(h[a : a + int(n_kmers[s])]))] = True
    chosen &= ~bad & (p0 <= last)
    idx = torch.nonzero(chosen).flatten()
    return seq_of[idx], idx - start[idx], h[idx], strand[idx]


@dataclass
class Index:
    hashes: torch.Tensor   # sorted distinct hashes kept
    offsets: torch.Tensor  # CSR into the entries
    unitig: torch.Tensor
    pos: torch.Tensor
    strand: torch.Tensor
    lengths: torch.Tensor  # every unitig's length


def build_index(codes: torch.Tensor, offsets: torch.Tensor, p: Params,
                block: int = 1 << 26) -> Index:
    """The index of the unitigs in ``codes``/``offsets``, sketched in
    blocks of about ``block`` bases."""
    dev = codes.device
    parts = []
    n = len(offsets) - 1
    s = 0
    while s < n:
        e = s + 1
        while e < n and int(offsets[e + 1] - offsets[s]) <= block:
            e += 1
        sub = offsets[s : e + 1] - offsets[s]
        seq, pos, h, strand = sketch(codes[int(offsets[s]) : int(offsets[e])], sub, p)
        parts.append((seq + s, pos, h, strand))
        s = e
    seq, pos, h, strand = (torch.cat(x) for x in zip(*parts)) if parts else (
        torch.zeros(0, dtype=torch.long, device=dev),) * 3 + (
        torch.zeros(0, dtype=torch.bool, device=dev),)
    h, order = torch.sort(h >> (32 - p.key_bits), stable=True)
    seq, pos, strand = seq[order], pos[order], strand[order]
    uniq, counts = torch.unique_consecutive(h, return_counts=True)
    keep = counts <= p.max_occ
    rows = torch.repeat_interleave(keep, counts)
    h, seq, pos, strand = h[rows], seq[rows], pos[rows], strand[rows]
    uniq, counts = uniq[keep], counts[keep]
    csr = torch.zeros(len(uniq) + 1, dtype=torch.long, device=dev)
    torch.cumsum(counts, 0, out=csr[1:])
    return Index(uniq, csr, seq, pos, strand, offsets[1:] - offsets[:-1])


@dataclass
class Mappings:
    """Mappings of a run of reads, by read and then in the read's order."""

    read: torch.Tensor
    unitig: torch.Tensor
    strand: torch.Tensor
    q_start: torch.Tensor
    q_end: torch.Tensor
    t_start: torch.Tensor
    t_end: torch.Tensor
    matches: torch.Tensor
    n_anchors: torch.Tensor


FIELDS = ("read", "unitig", "strand", "q_start", "q_end", "t_start", "t_end", "matches",
          "n_anchors")


def _bits(n: int) -> int:
    return max(int(n), 1).bit_length()


def map_reads(index: Index, codes: torch.Tensor, offsets: torch.Tensor, p: Params) -> Mappings:
    """Mappings of the reads in ``codes``/``offsets`` against ``index``."""
    dev = codes.device
    k = p.k
    read, t, h, rstrand = sketch(codes, offsets, p)
    h = h >> (32 - p.key_bits)
    if len(index.hashes):
        loc = torch.searchsorted(index.hashes, h).clamp(max=len(index.hashes) - 1)
        found = index.hashes[loc] == h
    else:
        loc, found = h, torch.zeros_like(h, dtype=torch.bool)
    read, t, rstrand, loc = read[found], t[found], rstrand[found], loc[found]
    lo = index.offsets[loc]
    counts = index.offsets[loc + 1] - lo
    total = int(counts.sum())
    empty = torch.zeros(0, dtype=torch.long, device=dev)
    if total == 0:
        return Mappings(*(empty,) * len(FIELDS))
    first = torch.cumsum(counts, 0) - counts
    src = torch.repeat_interleave(lo - first, counts) + torch.arange(total, device=dev)
    a_read = torch.repeat_interleave(read, counts)
    a_t = torch.repeat_interleave(t, counts)
    a_rel = index.strand[src] == torch.repeat_interleave(rstrand, counts)
    a_u = index.unitig[src]
    a_q = index.pos[src]
    key = a_u * 2 + a_rel.long()
    diag = torch.where(a_rel, a_t - a_q, a_t + a_q)

    # sort by (read, key, diagonal) in one int64 key
    d_off = int(index.lengths.max()) + 1
    d_bits = _bits(int(diag.max()) + d_off)
    k_bits = _bits(int(key.max()))
    if _bits(int(a_read.max())) + k_bits + d_bits > 62:
        raise ValueError("too many reads or unitigs for one sort key: map fewer reads at once")
    sort_key = (a_read << (k_bits + d_bits)) | (key << d_bits) | (diag + d_off)
    _, order = torch.sort(sort_key)
    a_read, key, diag = a_read[order], key[order], diag[order]
    a_q, a_t = a_q[order], a_t[order]
    new = torch.ones(total, dtype=torch.bool, device=dev)
    new[1:] = ((a_read[1:] != a_read[:-1]) | (key[1:] != key[:-1])
               | (diag[1:] - diag[:-1] > p.bandwidth))
    seg = torch.cumsum(new.long(), 0) - 1
    n_seg = int(seg[-1]) + 1
    starts = torch.nonzero(new).flatten()
    seg_n = torch.bincount(seg, minlength=n_seg)

    def reduce(x, how):
        init = x[starts].clone()
        return init.scatter_reduce(0, seg, x, how, include_self=True)

    q_min, q_max = reduce(a_q, "amin"), reduce(a_q, "amax")
    t_min, t_max = reduce(a_t, "amin"), reduce(a_t, "amax")
    # covered read bases: anchors of a chain by read position, gaps at most k
    t_bits = _bits(int(a_t.max()))
    _, o2 = torch.sort((seg << t_bits) | a_t)
    t2, s2 = a_t[o2], seg[o2]
    gaps = torch.zeros(total, dtype=torch.long, device=dev)
    gaps[1:] = torch.clamp(t2[1:] - t2[:-1], max=k)
    gaps[1:][s2[1:] != s2[:-1]] = 0
    covered = k + torch.zeros(n_seg, dtype=torch.long, device=dev).index_add_(0, s2, gaps)

    ok = (seg_n >= p.min_anchor_count) & (covered >= p.min_chain_score)
    s0 = starts[ok]
    return Mappings(a_read[s0], key[s0] // 2, (key[s0] % 2).bool(), q_min[ok], q_max[ok] + k,
                    t_min[ok], t_max[ok] + k, covered[ok], seg_n[ok])


def map_all_reads(index: Index, codes: torch.Tensor, offsets: torch.Tensor, p: Params,
                  block: int = 4096) -> Mappings:
    """``map_reads`` over every read, ``block`` reads at a time."""
    n = len(offsets) - 1
    parts = []
    for s in range(0, n, block):
        e = min(s + block, n)
        sub = offsets[s : e + 1] - offsets[s]
        m = map_reads(index, codes[int(offsets[s]) : int(offsets[e])], sub, p)
        m.read = m.read + s
        parts.append(m)
    if not parts:
        z = torch.zeros(0, dtype=torch.long, device=codes.device)
        return Mappings(*(z,) * len(FIELDS))
    return Mappings(*(torch.cat([getattr(m, f) for m in parts]) for f in FIELDS))


def paf_lines(m: Mappings, unitig_lengths: np.ndarray, read_lengths: np.ndarray,
              unitig_name, read_name) -> list[str]:
    """PAF lines (query = unitig, target = read) of ``m``, in its order."""
    cols = {f: getattr(m, f).cpu().numpy() for f in FIELDS}
    lines = []
    for i in range(len(cols["read"])):
        u, r = int(cols["unitig"][i]), int(cols["read"][i])
        qs, qe = int(cols["q_start"][i]), int(cols["q_end"][i])
        ts, te = int(cols["t_start"][i]), int(cols["t_end"][i])
        matches = int(cols["matches"][i])
        lines.append(
            f"{unitig_name(u)}\t{int(unitig_lengths[u])}\t{qs}\t{qe}\t"
            f"{'+' if cols['strand'][i] else '-'}\t{read_name(r)}\t{int(read_lengths[r])}\t"
            f"{ts}\t{te}\t{'*' if matches == UNCHECKED else matches}\t"
            f"{max(qe - qs, te - ts)}\t60")
    return lines
