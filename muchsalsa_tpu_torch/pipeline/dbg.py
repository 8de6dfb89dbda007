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

The port's copy of ``muchsalsa_tpu/pipeline/dbg.py``.  Its device leg
builds the extension table on a torch device (``ops/dbg_torch.py``) and
stitches on the host from it: ``device`` names the torch device, or is
False for the host walkers.
"""

from __future__ import annotations

import numpy as np

import torch

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

    def build(self, min_length: int = 500,
              device: bool | str | torch.device = False) -> list[bytes]:
        k = self.k
        if device is not False:
            # device leg: the 8N extension-existence queries (the
            # random-access half of the walk) batch on the torch device
            # (ops/dbg_torch.py); the serial stitch below runs with O(1)
            # table lookups per step.  Output identical to the native
            # and python walkers (tests/test_torch_dbg.py).
            from muchsalsa_tpu_torch import native
            from muchsalsa_tpu_torch.ops.dbg_torch import ext_indices_device

            vals = np.ascontiguousarray(self._kmers_sorted, dtype=np.uint64)
            ext = ext_indices_device(vals, k, device=device)
            if native.available():
                out = native.build_unitigs_from_ext_native(vals, k, ext, min_length)
                if out is not None:
                    return out
            return build_unitigs_from_ext(vals, ext, k, min_length)
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


def build_unitigs_from_ext(
    vals: np.ndarray, ext: np.ndarray, k: int, min_length: int = 500
) -> list[bytes]:
    """The serial unitig stitch driven by a precomputed extension-index
    table (``ops.dbg_torch.ext_indices_device``) — step-for-step the walk
    of :meth:`UnitigBuilder.build`, with every membership query an O(1)
    table lookup.

    ``vals``: sorted canonical k-mers (uint64); ``ext``: (N, 8) int32 —
    set index of the canonical form of extension j (j=base forward,
    4+base backward) or -1.  A raw k-mer in reverse-complement
    orientation reads the OPPOSITE block with complemented base
    (fwd-ext(rc(v), b) == rc(bwd-ext(v, 3-b)))."""
    N = len(vals)
    mask = (1 << (2 * k)) - 1
    fwd_deg = (ext[:, :4] >= 0).sum(axis=1).astype(np.int8)
    bwd_deg = (ext[:, 4:] >= 0).sum(axis=1).astype(np.int8)
    visited = np.zeros(N, dtype=bool)
    unitigs: list[bytes] = []

    def exts_of(i: int, orient: int, forward: bool):
        """(count, base, target_index) of the raw k-mer's extensions in
        direction ``forward`` (base meaningful only when count == 1)."""
        use_fwd_block = (orient == 0) == forward
        deg = fwd_deg[i] if use_fwd_block else bwd_deg[i]
        if deg != 1:
            return int(deg), -1, -1
        row = ext[i]
        off = 0 if use_fwd_block else 4
        for bb in range(4):
            j = row[off + bb]
            if j >= 0:
                b = bb if orient == 0 else 3 - bb
                return 1, b, int(j)
        return 0, -1, -1  # unreachable

    for start in range(N):
        if visited[start]:
            continue

        def walk(i0: int, cur0: int, forward: bool) -> list[int]:
            path = []
            i, cur, orient = i0, cur0, 0
            while True:
                cnt, b, j = exts_of(i, orient, forward)
                if cnt != 1:
                    break
                if forward:
                    nxt = ((cur << 2) | b) & mask
                else:
                    nxt = (cur >> 2) | (b << (2 * (k - 1)))
                if visited[j] or j == i:
                    break
                orient2 = 0 if nxt == int(vals[j]) else 1
                # the next node must also have a unique back-extension
                back_cnt, _b2, _j2 = exts_of(j, orient2, not forward)
                if back_cnt != 1:
                    break
                path.append(nxt)
                visited[j] = True
                i, cur, orient = j, nxt, orient2
            return path

        visited[start] = True
        sv = int(vals[start])
        fwd_path = walk(start, sv, True)
        bwd_path = walk(start, sv, False)

        chain = list(reversed(bwd_path)) + [sv] + fwd_path
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
                  device: bool | str | torch.device = False) -> list[bytes]:
    return UnitigBuilder(seqs, k, min_count).build(min_length, device=device)
