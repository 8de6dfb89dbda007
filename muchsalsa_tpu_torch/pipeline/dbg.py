"""De Bruijn unitig construction from short reads.

The reference delegates short-read assembly to external ``abyss-pe``
(``pipeline/pipeline.sh:157``) and only length-filters the result
(>= 500bp, ``pipeline.sh:159``).  This module provides the native
equivalent so the full pipeline runs without external binaries: a
k-mer de Bruijn graph whose maximal non-branching paths become unitigs.

Method: canonical k-mer counting -> drop low-coverage k-mers (sequencing
errors) -> node = k-mer, edges implied by (k-1)-overlaps found via
existence queries of the 4 possible extensions -> walk maximal
unambiguous paths on both strands.

The port's copy of the host paths of ``muchsalsa_tpu/pipeline/dbg.py``:
``device=True`` raises (the device leg, ``ops/dbg_jax.py``, and the
table-driven stitch that serves only it are ROADMAP.md §1 item 10).
"""

from __future__ import annotations

import numpy as np

from muchsalsa_tpu_torch.pipeline.kmer import count_kmers, kmer_values64
from muchsalsa_tpu_torch.utils.seq import encode_2bit, reverse_complement

_DECODE = b"ACGT"


def _canon(v: int, k: int) -> int:
    return min(v, _revcomp_val(v, k))


def _revcomp_val(v: int, k: int) -> int:
    out = 0
    for _ in range(k):
        out = (out << 2) | (3 - (v & 3))
        v >>= 2
    return out


class UnitigBuilder:
    def __init__(self, seqs, k: int = 31, min_count: int = 2):
        self.k = k
        uniq, counts = count_kmers(seqs, k)
        self._kmers_sorted = uniq[counts >= min_count]
        self._kmers_set: set[int] | None = None

    @property
    def kmers(self) -> set[int]:
        # python-path membership set, built lazily (the native build
        # binary-searches the sorted array instead)
        if self._kmers_set is None:
            self._kmers_set = set(int(x) for x in self._kmers_sorted)
        return self._kmers_set

    def _extensions(self, v: int, forward: bool) -> list[tuple[int, int]]:
        """Canonical-set successors (forward) / predecessors of k-mer v."""
        k = self.k
        mask = (1 << (2 * k)) - 1
        out = []
        for b in range(4):
            if forward:
                nxt = ((v << 2) | b) & mask
            else:
                nxt = (v >> 2) | (b << (2 * (k - 1)))
            if _canon(nxt, k) in self.kmers:
                out.append((b, nxt))
        return out

    def build(self, min_length: int = 500, device: bool = False) -> list[bytes]:
        k = self.k
        if device:
            raise NotImplementedError(
                "the DBG device leg is not ported to muchsalsa_tpu_torch yet "
                "(ROADMAP.md §1 item 10); build unitigs on the host")
        if k <= 31:
            from muchsalsa_tpu_torch import native

            if native.available():
                out = native.build_unitigs_native(
                    np.ascontiguousarray(self._kmers_sorted, dtype=np.uint64),
                    k, min_length,
                )
                if out is not None:
                    return out

        visited: set[int] = set()
        unitigs: list[bytes] = []

        for start in sorted(self.kmers):
            if start in visited:
                continue

            # expand in both directions while extension is unambiguous
            def walk(v: int, forward: bool) -> list[int]:
                path = []
                cur = v
                while True:
                    exts = self._extensions(cur, forward)
                    if len(exts) != 1:
                        break
                    nxt = exts[0][1]
                    c = _canon(nxt, k)
                    if c in visited or c == _canon(cur, k):
                        break
                    # the next node must also have a unique back-extension
                    back = self._extensions(nxt, not forward)
                    if len(back) != 1:
                        break
                    path.append(nxt)
                    visited.add(c)
                    cur = nxt
                return path

            visited.add(start)
            fwd_path = walk(start, True)
            bwd_path = walk(start, False)

            chain = list(reversed(bwd_path)) + [start] + fwd_path
            seq = bytearray()
            first = chain[0]
            for i in range(k):
                seq.append(_DECODE[(first >> (2 * (k - 1 - i))) & 3])
            for v in chain[1:]:
                seq.append(_DECODE[v & 3])
            if len(seq) >= min_length:
                unitigs.append(bytes(seq))

        return unitigs


def build_unitigs(seqs, k: int = 31, min_count: int = 2, min_length: int = 500,
                  device: bool = False) -> list[bytes]:
    return UnitigBuilder(seqs, k, min_count).build(min_length, device=device)
