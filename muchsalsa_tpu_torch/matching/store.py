"""Dense match store — the TPU-native MatchMap.

Reference counterpart: ``matching::MatchMap`` (``libms/src/matching/MatchMap.cpp``,
``include/ms/matching/MatchMap.h:51-87``).  Differences by design:

- Matches live in sorted struct-of-arrays tables instead of nested
  hash maps guarded by shared mutexes; lookups are binary searches over
  a packed ``(nano_id, illu_id)`` key and bulk lookups are vectorised
  gathers, which is what the batched chaining kernel consumes.
- Deduplication per ``(nano, illu)`` pair keeps the lowest PAF line
  number, the same fixed point the reference's ``addVertexMatch`` race
  converges to (``MatchMap.cpp:64-76``).
- Vertex metadata (the PAF line index used for deterministic edge
  ordering, ``BlastFileReader.cpp:113``) is the *minimum* line index of
  the read's kept matches — the deterministic value of the reference's
  first-insert-wins race (``Graph.cpp:141-148``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from muchsalsa_tpu_torch.io.paf import PafRecords


@dataclass
class MatchStore:
    """Deduped vertex matches + vertex table, sorted by (nano_id, illu_id)."""

    # match rows (one per surviving (nano, illu) pair)
    nano_id: np.ndarray
    illu_id: np.ndarray
    nano_start: np.ndarray
    nano_end: np.ndarray     # inclusive
    illu_start: np.ndarray
    illu_end: np.ndarray     # inclusive
    rratio: np.ndarray       # float64
    direction: np.ndarray    # bool
    score: np.ndarray        # int64
    is_primary: np.ndarray   # bool
    line: np.ndarray         # int64

    # vertex table, aligned over sorted unique nano ids
    vertex_ids: np.ndarray       # int32, sorted
    vertex_length: np.ndarray    # int32
    vertex_meta_line: np.ndarray  # int64

    _key: np.ndarray = None      # packed (nano, illu) sort key
    _illu_stride: int = 0

    # ------------------------------------------------------------------ build

    @staticmethod
    def from_paf(records: PafRecords) -> "MatchStore":
        n = len(records)
        if n == 0:
            empty_i32 = np.zeros(0, dtype=np.int32)
            empty_i64 = np.zeros(0, dtype=np.int64)
            empty_b = np.zeros(0, dtype=bool)
            return MatchStore(
                empty_i32, empty_i32, empty_i32, empty_i32, empty_i32, empty_i32,
                np.zeros(0), empty_b, empty_i64, empty_b, empty_i64,
                empty_i32, empty_i32, empty_i64,
            )

        stride = int(records.illu_id.max()) + 1
        key = records.nano_id.astype(np.int64) * stride + records.illu_id
        # stable sort by (key, line): first row of each key group = min line
        order = np.lexsort((records.line_idx, key))
        key_sorted = key[order]
        first = np.ones(n, dtype=bool)
        first[1:] = key_sorted[1:] != key_sorted[:-1]
        keep = order[first]

        # vertex table over *all* kept PAF rows (vertices exist even when
        # their (nano, illu) match was deduped away)
        vertex_ids, inv = np.unique(records.nano_id, return_inverse=True)
        meta_line = np.full(len(vertex_ids), np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(meta_line, inv, records.line_idx)
        # nanopore length of the meta (minimum) line — constant per read in
        # well-formed input, but resolved deterministically regardless.
        length = np.zeros(len(vertex_ids), dtype=np.int32)
        min_order = np.argsort(records.line_idx, kind="stable")[::-1]
        length[inv[min_order]] = records.nano_length[min_order]

        illu_len = (records.illu_end - records.illu_start + 1).astype(np.float64)
        nano_len = (records.nano_end - records.nano_start + 1).astype(np.float64)
        rratio = illu_len / nano_len

        return MatchStore(
            nano_id=records.nano_id[keep],
            illu_id=records.illu_id[keep],
            nano_start=records.nano_start[keep],
            nano_end=records.nano_end[keep],
            illu_start=records.illu_start[keep],
            illu_end=records.illu_end[keep],
            rratio=rratio[keep],
            direction=records.direction[keep],
            score=records.score[keep],
            is_primary=records.is_primary[keep],
            line=records.line_idx[keep],
            vertex_ids=vertex_ids.astype(np.int32),
            vertex_length=length,
            vertex_meta_line=meta_line,
            _key=key_sorted[first],
            _illu_stride=stride,
        )

    def __post_init__(self) -> None:
        if self._key is None:
            stride = int(self.illu_id.max()) + 1 if len(self.illu_id) else 1
            self._illu_stride = stride
            self._key = self.nano_id.astype(np.int64) * stride + self.illu_id

    # ----------------------------------------------------------------- lookup

    def __len__(self) -> int:
        return len(self.nano_id)

    def rows(self, nano: np.ndarray | int, illu: np.ndarray | int) -> np.ndarray:
        """Row indices for (nano, illu) pairs; -1 where absent (vectorised)."""
        want = np.asarray(nano, dtype=np.int64) * self._illu_stride + np.asarray(illu)
        pos = np.searchsorted(self._key, want)
        pos = np.minimum(pos, max(len(self._key) - 1, 0))
        ok = len(self._key) > 0
        hit = (self._key[pos] == want) if ok else np.zeros_like(pos, dtype=bool)
        return np.where(hit, pos, -1)

    def row(self, nano: int, illu: int) -> int:
        """Fast scalar lookup (hot in consensus — avoids array wrappers)."""
        want = int(nano) * self._illu_stride + int(illu)
        key = self._key
        pos = int(key.searchsorted(want))
        if pos < len(key) and int(key[pos]) == want:
            return pos
        return -1

    def vertex_index(self, nano: np.ndarray | int) -> np.ndarray:
        idx = np.searchsorted(self.vertex_ids, nano)
        return idx

    def vertex_rows(self, nano: int) -> np.ndarray:
        """All match-row indices of one nanopore read (sorted by illu id)."""
        lo = np.searchsorted(self.nano_id, nano, side="left")
        hi = np.searchsorted(self.nano_id, nano, side="right")
        return np.arange(lo, hi)

    def sorted_illu_ids(self, nano: int) -> list[int]:
        """Unitig ids of one read sorted by (nano range, id) — the
        vIDsStart/vIDsEnd lists of the chaining shadow scan (cached)."""
        if not hasattr(self, "_sorted_ids_cache"):
            object.__setattr__(self, "_sorted_ids_cache", {})
        cache = self._sorted_ids_cache
        out = cache.get(nano)
        if out is None:
            r = self.vertex_rows(nano)
            order = np.lexsort((self.illu_id[r], self.nano_end[r], self.nano_start[r]))
            out = [int(x) for x in self.illu_id[r][order]]
            cache[nano] = out
        return out

    @property
    def n_vertices(self) -> int:
        return len(self.vertex_ids)


@dataclass
class EdgeMatches:
    """Edge table + per-(edge, unitig) overlap records.

    Reference counterpart: the graph's edge set plus
    ``MatchMap::m_edgeMatches`` (``MatchMap.h:212-217``), built by
    ``processScaffold`` (``MatchMap.cpp:175-224``).

    Edges are vertex-id pairs ordered by vertex meta line (the
    reference's ``getMetaDatum<std::size_t>(0)`` ordering,
    ``MatchMap.cpp:204-213``), sorted canonically by (line_v, line_w).
    ``em_*`` rows are grouped by edge and sorted by (edge, illu).
    """

    edge_v: np.ndarray  # int32 vertex id (earlier meta line)
    edge_w: np.ndarray  # int32 vertex id
    em_edge: np.ndarray     # int32 index into edge_v/edge_w
    em_illu: np.ndarray     # int32
    em_ov_start: np.ndarray  # int32, inclusive
    em_ov_end: np.ndarray    # int32, inclusive
    em_direction: np.ndarray  # bool (outer.dir == inner.dir)
    em_score: np.ndarray     # float64 sum score
    em_primary: np.ndarray   # bool
    em_line: np.ndarray      # int64 (outer match's line number)

    em_offsets: np.ndarray = None  # int64, CSR offsets per edge (len = n_edges+1)

    def __post_init__(self) -> None:
        if self.em_offsets is None:
            counts = np.bincount(self.em_edge, minlength=len(self.edge_v))
            self.em_offsets = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)

    @property
    def n_edges(self) -> int:
        return len(self.edge_v)

    def edge_rows(self, edge_idx: int) -> np.ndarray:
        return np.arange(self.em_offsets[edge_idx], self.em_offsets[edge_idx + 1])
