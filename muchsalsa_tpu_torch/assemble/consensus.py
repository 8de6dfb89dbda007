"""Per-path consensus construction and contig emission.

Reference counterpart: ``assemblePath`` + helpers
(``libms/src/kernel/ap.cpp`` — the largest reference kernel, 1364 LoC).
Stages mirrored 1:1 (numbers refer to ap.cpp):

1. candidate DP along the path choosing one EdgeOrder per edge,
   minimizing "kinks" then maximizing score (615-706);
2. anchor clustering per unitig id via Ramsey-R2 clique cover (91-189);
3. per-vertex anchor ordering + anchor DiGraph ("adg") construction with
   flip detection (191-203, 759-853), plus pre/post flank sequences
   (352-422);
4. inter-anchor gap alignment: distance + candidate filler sequences
   (435-611), global distance taken from the *first* spanning read;
5. ``visitOrdered`` topological sweep placing anchors on a global axis
   ("tap") and stitching the consensus via extend-only
   ``updateConsensusBase`` (205-349);
6. disconnected sub-order merging (897-1010);
7. longest pre/post flank append (1012-1032);
8. emission of the target contig + query/PAF rows for external polishing
   (1034-1361).

String splicing stays host-side (strings don't fit the XLA model —
SURVEY.md §7); coordinate math is trivially arithmetic.  All arithmetic
quirks of the reference are reproduced deliberately, including
``strSlice``'s inclusive-end duplication on left extensions.
"""

from __future__ import annotations

import math
import heapq
from dataclasses import dataclass
from functools import cmp_to_key

from muchsalsa_tpu_torch.assemble.contraction import ContainElement
from muchsalsa_tpu_torch.graph.graph import DiGraph, Direction, Edge, Graph, VertexInfo
from muchsalsa_tpu_torch.io.fasta import SequenceStore
from muchsalsa_tpu_torch.io.output import OutputWriter
from muchsalsa_tpu_torch.matching.store import EdgeMatches, MatchStore
from muchsalsa_tpu_torch.utils.seq import reverse_complement, str_slice, wrap_sequence


# Counters for the two deliberate divergences from ap.cpp (which would
# crash / spin there).  The driver copies these into StageTimer counters
# so parity investigations can see when they fired.
FALLBACK_COUNTS: dict[str, int] = {
    "consensus_cyclic_adg_fallback": 0,
    "consensus_stranded_suborder_drop": 0,
}


def reset_fallback_counts() -> None:
    for key in FALLBACK_COUNTS:
        FALLBACK_COUNTS[key] = 0


# ---------------------------------------------------------------------------
# context


class ConsensusContext:
    """Bundles match tables + sequence stores for consensus."""

    def __init__(
        self,
        store: MatchStore,
        edge_matches: EdgeMatches,
        nano_seqs: SequenceStore,
        illu_seqs: SequenceStore,
        th_sequence_length: int = 200,
        sequence_line_length: int = 60,
    ):
        self.store = store
        self.edge_matches = edge_matches
        self.nano_seqs = nano_seqs
        self.illu_seqs = illu_seqs
        self.th_sequence_length = th_sequence_length
        self.sequence_line_length = sequence_line_length
        self._vm_cache: dict[tuple[int, int], int] = {}
        self._em_cache: dict[tuple[int, int], tuple[int, int]] = {}

    # -- match lookups -------------------------------------------------------

    def vm(self, nano: int, illu: int) -> int:
        key = (nano, illu)
        row = self._vm_cache.get(key)
        if row is None:
            row = self.store.row(nano, illu)
            self._vm_cache[key] = row
        if row < 0:
            raise KeyError(f"no vertex match ({nano}, {illu})")
        return row

    def em_overlap(self, em_idx: int, illu: int) -> tuple[int, int]:
        key = (em_idx, illu)
        out = self._em_cache.get(key)
        if out is not None:
            return out
        em = self.edge_matches
        lo = int(em.em_offsets[em_idx])
        hi = int(em.em_offsets[em_idx + 1])
        pos = lo + int(em.em_illu[lo:hi].searchsorted(illu))
        if pos >= hi or em.em_illu[pos] != illu:
            raise KeyError(f"no edge match (edge {em_idx}, illu {illu})")
        out = (int(em.em_ov_start[pos]), int(em.em_ov_end[pos]))
        self._em_cache[key] = out
        return out

    # -- sequence access (SequenceUtils.cpp:63-85) ---------------------------

    def illu_seq(self, illu: int, left: int, right: int, direction: bool) -> str:
        s = str_slice(self.illu_seqs.sequence_str(illu), left, right + 1)
        return reverse_complement(s) if not direction else s

    def nano_seq(self, nano: int, left: int, right: int, direction: bool) -> str:
        s = str_slice(self.nano_seqs.sequence_str(nano), left, right + 1)
        return reverse_complement(s) if not direction else s


# ---------------------------------------------------------------------------
# coordinate helpers


def get_corrected_nanopore_range(
    ctx: ConsensusContext, nano: int, illu: int, overlap: tuple[int, int]
) -> tuple[float, float]:
    """ap.cpp:191-203."""
    r = ctx.vm(nano, illu)
    s = ctx.store
    ncl = (overlap[0] - s.illu_start[r]) / s.rratio[r]
    ncr = (s.illu_end[r] - overlap[1]) / s.rratio[r]
    if not s.direction[r]:
        ncl, ncr = ncr, ncl
    return float(s.nano_start[r]) + ncl, float(s.nano_end[r]) - ncr


class ChunkedSeq:
    """Extend-only sequence: O(1) amortised prepend/append of string
    chunks with lazy join.  The consensus only ever extends its borders
    (``updateConsensusBase`` never rewrites the interior, ap.cpp:205-229),
    so plain-str concatenation would be O(L^2) in contig length — fatal
    at 100Mb+ genomes."""

    __slots__ = ("chunks", "length")

    def __init__(self, s: "str | ChunkedSeq" = ""):
        if isinstance(s, ChunkedSeq):
            self.chunks = list(s.chunks)
            self.length = s.length
        else:
            self.chunks = [s] if s else []
            self.length = len(s)

    def __len__(self) -> int:
        return self.length

    def append(self, s: str) -> None:
        if s:
            self.chunks.append(s)
            self.length += len(s)

    def prepend(self, s: str) -> None:
        if s:
            self.chunks.insert(0, s)
            self.length += len(s)

    def prefix(self, n: int) -> str:
        """First min(n, len) characters."""
        if n >= self.length:
            return self.materialize()
        out = []
        need = n
        for c in self.chunks:
            if need <= 0:
                break
            out.append(c[:need])
            need -= len(c)
        return "".join(out)

    def suffix(self, n: int) -> str:
        """Last min(n, len) characters."""
        if n >= self.length:
            return self.materialize()
        out = []
        need = n
        for c in reversed(self.chunks):
            if need <= 0:
                break
            out.append(c[-need:] if need < len(c) else c)
            need -= len(c)
        return "".join(reversed(out))

    def materialize(self) -> str:
        if len(self.chunks) != 1:
            joined = "".join(self.chunks)
            self.chunks = [joined] if joined else []
        return self.chunks[0] if self.chunks else ""


def _new_prefix(new_seq, count: int) -> str:
    """``strSlice(new, 0, count-1)`` — first ``count`` chars, clamped."""
    if isinstance(new_seq, ChunkedSeq):
        return new_seq.prefix(count)
    return new_seq[:count]


def _new_suffix(new_seq, count: int) -> str:
    """``strSlice(new, -count, len)`` — last ``count`` chars; the whole
    string when count >= len (C++ size_t-cast edge, SequenceUtils.cpp)."""
    if isinstance(new_seq, ChunkedSeq):
        return new_seq.suffix(count) if count < len(new_seq) else new_seq.materialize()
    return new_seq[-count:] if 0 < count < len(new_seq) else (new_seq if count > 0 else "")


def update_consensus_base(
    old_seq: "ChunkedSeq | None",
    old_borders: tuple[int, int],
    new_seq: "str | ChunkedSeq",
    new_borders: tuple[int, int],
) -> tuple["ChunkedSeq", int, int]:
    """ap.cpp:205-229 — extend-only consensus update (interior never
    rewritten; left extension reproduces the strSlice inclusive-end
    duplication: the prepended piece is ``[0, delta]`` inclusive)."""
    if old_seq is None:
        return ChunkedSeq(new_seq), new_borders[0], new_borders[1]

    if new_borders[0] < old_borders[0]:
        border_right = old_borders[0] - new_borders[0]
        # strSlice(new, 0, border_right) keeps border_right+1 chars
        old_seq.prepend(_new_prefix(new_seq, border_right + 1))
    elif new_borders[1] > old_borders[1]:
        delta = new_borders[1] - old_borders[1]
        old_seq.append(_new_suffix(new_seq, delta))

    return (
        old_seq,
        min(old_borders[0], new_borders[0]),
        max(old_borders[1], new_borders[1]),
    )


# ---------------------------------------------------------------------------
# anchor clique clustering (ap.cpp:91-189)


def ramsey_r2(g: Graph, vertices: list[int]) -> list[int]:
    if not vertices:
        return []
    first = vertices[0]
    neigh = [v for v in vertices[1:] if g.has_edge(first, v)]
    non = [v for v in vertices[1:] if not g.has_edge(first, v)]
    clique_n = ramsey_r2(g, neigh)
    clique_nn = ramsey_r2(g, non)
    clique_n.append(first)
    return clique_n if len(clique_n) >= len(clique_nn) else clique_nn


def get_anchor_cliques(g: Graph, vertices_in_order: list[int]) -> list[list[int]]:
    vertices = list(vertices_in_order)
    current = ramsey_r2(g, vertices)
    cliques = [current]
    remaining = list(vertices)
    while remaining:
        drop = set(current)
        remaining = [v for v in remaining if v not in drop]
        current = ramsey_r2(g, remaining)
        if current:
            cliques.append(current)
    return cliques


def get_cluster_anchors(
    ctx: ConsensusContext,
    cluster_modifier: list[dict[int, int]],
    id2overlap: dict[tuple[int, int], tuple[int, int]],
    illu_base: int,
    edge_idx_list: list[int],
    edges: list[Edge],
) -> None:
    """ap.cpp:140-189."""
    g = Graph()
    insertion: list[int] = []
    for idx1 in edge_idx_list:
        if not g.has_vertex(idx1):
            g.add_vertex(VertexInfo(idx1))
            insertion.append(idx1)
        for idx2 in edge_idx_list:
            if idx1 == idx2:
                break
            ov1 = ctx.em_overlap(edges[idx1].em_idx, illu_base)
            ov2 = ctx.em_overlap(edges[idx2].em_idx, illu_base)
            lo = max(ov1[0], ov2[0])
            hi = min(ov1[1], ov2[1])
            if lo <= hi:
                g.add_edge(idx2, idx1)

    cliques = get_anchor_cliques(g, insertion)

    for clique_idx, clique in enumerate(cliques):
        common: tuple[int, int] | None = None
        for edge_idx in clique:
            cluster_modifier[edge_idx][illu_base] = clique_idx
            ov = ctx.em_overlap(edges[edge_idx].em_idx, illu_base)
            if common is None:
                common = ov
            else:
                common = (max(common[0], ov[0]), min(common[1], ov[1]))
        id2overlap[(illu_base, clique_idx)] = common


# ---------------------------------------------------------------------------
# flank + gap sequences (ap.cpp:352-611)


def get_sequence_left_of_anchor(
    ctx: ConsensusContext,
    nano: int,
    nano_length: int,
    illu: int,
    overlap: tuple[int, int],
    direction: bool,
) -> str:
    r = ctx.vm(nano, illu)
    s = ctx.store
    if not direction:
        if not s.direction[r]:
            seq = ctx.illu_seq(illu, int(s.illu_start[r]), overlap[0], False)
        else:
            seq = ctx.illu_seq(illu, overlap[1], int(s.illu_end[r]), True)
        seq += ctx.nano_seq(nano, int(s.nano_end[r]), nano_length - 1, True)
        return reverse_complement(seq)

    seq = ctx.nano_seq(nano, 0, int(s.nano_start[r]), True)
    if not s.direction[r]:
        seq += ctx.illu_seq(illu, overlap[1], int(s.illu_end[r]), False)
    else:
        seq += ctx.illu_seq(illu, int(s.illu_start[r]), overlap[0], True)
    return seq


def get_sequence_right_of_anchor(
    ctx: ConsensusContext,
    nano: int,
    nano_length: int,
    illu: int,
    overlap: tuple[int, int],
    direction: bool,
) -> str:
    r = ctx.vm(nano, illu)
    s = ctx.store
    if not direction:
        seq = ctx.nano_seq(nano, 0, int(s.nano_start[r]), True)
        if not s.direction[r]:
            seq += ctx.illu_seq(illu, overlap[1], int(s.illu_end[r]), False)
        else:
            seq += ctx.illu_seq(illu, int(s.illu_start[r]), overlap[0], True)
        return reverse_complement(seq)

    if not s.direction[r]:
        seq = ctx.illu_seq(illu, int(s.illu_start[r]), overlap[0], False)
    else:
        seq = ctx.illu_seq(illu, overlap[1], int(s.illu_end[r]), True)
    seq += ctx.nano_seq(nano, int(s.nano_end[r]), nano_length - 1, True)
    return seq


def get_anchor_sequence(
    ctx: ConsensusContext, nano: int, illu: int, overlap: tuple[int, int], direction: bool
) -> str:
    r = ctx.vm(nano, illu)
    combined = bool(ctx.store.direction[r]) == direction  # Toggle product
    return ctx.illu_seq(illu, overlap[0], overlap[1], combined)


def get_sequence_between_anchors(
    ctx: ConsensusContext,
    nano: int,
    illu_left: int,
    illu_right: int,
    overlap_left: tuple[int, int],
    overlap_right: tuple[int, int],
    direction: bool,
) -> tuple[int, str | None]:
    """ap.cpp:435-579."""
    rl = ctx.vm(nano, illu_left)
    rr_ = ctx.vm(nano, illu_right)
    s = ctx.store

    il_s, il_e = int(s.illu_start[rl]), int(s.illu_end[rl])
    ir_s, ir_e = int(s.illu_start[rr_]), int(s.illu_end[rr_])
    rratio_l, rratio_r = float(s.rratio[rl]), float(s.rratio[rr_])
    nl_s, nl_e = int(s.nano_start[rl]), int(s.nano_end[rl])
    nr_s, nr_e = int(s.nano_start[rr_]), int(s.nano_end[rr_])
    dir_l, dir_r = bool(s.direction[rl]), bool(s.direction[rr_])

    correction_left = 0
    correction_right = 0

    if not direction:
        error_offset = float(nr_e - nl_s)
        if error_offset > 0:
            cn_left = get_corrected_nanopore_range(ctx, nano, illu_left, overlap_left)
            cn_right = get_corrected_nanopore_range(ctx, nano, illu_right, overlap_right)
            if cn_left[0] < cn_right[1]:
                return math.floor(cn_left[0] - cn_right[1]), None

            if not dir_l:
                available_left = (il_e - overlap_left[1]) / rratio_l
                correction_left = il_e - overlap_left[1]
            else:
                available_left = (overlap_left[0] - il_s) / rratio_l
                correction_left = overlap_left[0] - il_s
            if available_left > error_offset:
                correction_left = int(math.floor(error_offset * rratio_l))
                error_offset = 0.0
            else:
                error_offset -= available_left

            if not dir_r:
                available_right = (overlap_right[0] - ir_s) / rratio_r
                correction_right = overlap_right[0] - ir_s
            else:
                available_right = (ir_e - overlap_right[1]) / rratio_r
                correction_right = ir_e - overlap_right[1]
            if available_right > error_offset:
                correction_right = int(math.floor(error_offset * rratio_r))

        if not dir_r:
            seq = ctx.illu_seq(illu_right, ir_s + correction_right, overlap_right[0], False)
        else:
            seq = ctx.illu_seq(illu_right, overlap_right[1], ir_e - correction_right, True)
        seq += ctx.nano_seq(nano, nr_e, nl_s, True)
        if not dir_l:
            seq += ctx.illu_seq(illu_left, overlap_left[1], il_e - correction_left, False)
        else:
            seq += ctx.illu_seq(illu_left, il_s + correction_left, overlap_left[0], True)
        return len(seq), reverse_complement(seq)

    error_offset = float(nl_e - nr_s)
    if error_offset > 0:
        cn_left = get_corrected_nanopore_range(ctx, nano, illu_left, overlap_left)
        cn_right = get_corrected_nanopore_range(ctx, nano, illu_right, overlap_right)
        if cn_left[1] > cn_right[0]:
            return math.floor(cn_right[0] - cn_left[1]), None

        if not dir_l:
            available_left = (overlap_left[0] - il_s) / rratio_l
            correction_left = overlap_left[0] - il_s
        else:
            available_left = (il_e - overlap_left[1]) / rratio_l
            correction_left = il_e - overlap_left[1]
        if available_left > error_offset:
            correction_left = int(math.floor(error_offset * rratio_l))
            error_offset = 0.0
        else:
            error_offset -= available_left

        if not dir_r:
            available_right = (ir_e - overlap_right[1]) / rratio_r
            correction_right = ir_e - overlap_right[1]
        else:
            available_right = (overlap_right[0] - ir_s) / rratio_r
            correction_right = overlap_right[0] - ir_s
        if available_right > error_offset:
            correction_right = int(math.floor(error_offset * rratio_r))

    if not dir_l:
        seq = ctx.illu_seq(illu_left, il_s + correction_left, overlap_left[0], False)
    else:
        seq = ctx.illu_seq(illu_left, overlap_left[1], il_e - correction_left, True)
    seq += ctx.nano_seq(nano, nl_e, nr_s, True)
    if not dir_r:
        seq += ctx.illu_seq(illu_right, overlap_right[1], ir_e - correction_right, False)
    else:
        seq += ctx.illu_seq(illu_right, ir_s + correction_right, overlap_right[0], True)
    return len(seq), seq


# ---------------------------------------------------------------------------
# visitOrdered (ap.cpp:231-349)


def visit_ordered(
    visited: dict[int, bool],
    tap: dict[int, tuple[int, int]],
    adg: DiGraph,
    reg_idx2id: dict[int, tuple[int, int]],
    v2order: dict[int, int],
    order: list[int],
    distances: dict[Edge, int],
    sequences: dict[Edge, list[str]],
    anchor_sequences: dict[int, str],
    id2overlap: dict[tuple[int, int], tuple[int, int]],
    start_vid: int,
) -> tuple[str | None, int, int]:
    sequence: str | None = None
    border_left = border_right = 0

    qe: list[tuple[int, int]] = []  # heap keyed (succ order idx, -pred idx)
    qv: list[int] = [v2order[start_vid]]
    qv_set = {v2order[start_vid]}

    while qv:
        idx = heapq.heappop(qv)
        qv_set.discard(idx)
        vid = order[idx]

        if not visited.get(vid, False):
            visited[vid] = True

            for target in sorted(adg.successors(vid)):
                succ_idx = v2order[target]
                heapq.heappush(qe, (succ_idx, -idx))
                if succ_idx not in qv_set:
                    heapq.heappush(qv, succ_idx)
                    qv_set.add(succ_idx)

            while qe and qe[0][0] == idx:
                first, neg_second = heapq.heappop(qe)
                left_vid = order[-neg_second]
                right_vid = order[first]

                has_left = left_vid in tap
                has_right = right_vid in tap

                ov_left = id2overlap[reg_idx2id[left_vid]]
                ov_right = id2overlap[reg_idx2id[right_vid]]

                edge = adg.get_edge(left_vid, right_vid)
                offset = distances[edge]

                length_left = ov_left[1] - ov_left[0] + 1
                length_right = ov_right[1] - ov_right[0] + 1

                def filler() -> str:
                    seqs = sequences[edge]
                    return seqs[0] if seqs else ""

                if has_left and not has_right:
                    pos_right = tap[left_vid][1]
                    tap[right_vid] = (pos_right + offset + 1, pos_right + offset + length_right)
                    if offset > 0:
                        sequence, border_left, border_right = update_consensus_base(
                            sequence, (border_left, border_right), filler(),
                            (pos_right + 1, pos_right + offset),
                        )
                    sequence, border_left, border_right = update_consensus_base(
                        sequence, (border_left, border_right),
                        anchor_sequences[right_vid], tap[right_vid],
                    )
                elif not has_left and has_right:
                    pos_right = tap[right_vid][0]
                    tap[left_vid] = (pos_right - offset - length_left, pos_right - offset - 1)
                    if offset > 0:
                        sequence, border_left, border_right = update_consensus_base(
                            sequence, (border_left, border_right), filler(),
                            (pos_right - offset, pos_right),
                        )
                    sequence, border_left, border_right = update_consensus_base(
                        sequence, (border_left, border_right),
                        anchor_sequences[left_vid], tap[left_vid],
                    )
                elif not has_left and not has_right:
                    tap[left_vid] = (0, length_left - 1)
                    tap[right_vid] = (length_left + offset, length_left + offset + length_right - 1)
                    if offset > 0:
                        sequence, border_left, border_right = update_consensus_base(
                            sequence, (border_left, border_right), filler(),
                            (length_left, length_left + offset - 1),
                        )
                    sequence, border_left, border_right = update_consensus_base(
                        sequence, (border_left, border_right),
                        anchor_sequences[left_vid], tap[left_vid],
                    )
                    sequence, border_left, border_right = update_consensus_base(
                        sequence, (border_left, border_right),
                        anchor_sequences[right_vid], tap[right_vid],
                    )
        else:
            while qe and qe[0][0] == idx:
                heapq.heappop(qe)

    return sequence, border_left, border_right


# ---------------------------------------------------------------------------
# candidate DP (ap.cpp:621-706)


@dataclass
class _Candidate:
    open_ids: set
    visited_ids: set
    score: float
    kinks: int
    edges: list
    orders: list
    modifiers: list


def _find_best(candidates: list[_Candidate]) -> tuple[int | None, float | None]:
    min_kinks: int | None = None
    max_score: float | None = None
    for cand in candidates:
        if (
            min_kinks is None
            or cand.kinks < min_kinks
            or (cand.kinks == min_kinks and (max_score is None or cand.score > max_score))
        ):
            min_kinks = cand.kinks
            max_score = cand.score
    return min_kinks, max_score


def _write_paf_row(
    writer: OutputWriter,
    query_name: str,
    seq_len: int,
    target_name: str,
    target_len: int,
    lb: int,
    rb: int,
) -> None:
    span = rb - lb + 1
    writer.write_paf(
        f"{query_name}\t{seq_len}\t0\t{seq_len}\t+\t{target_name}\t{target_len}"
        f"\t{lb}\t{rb}\t{span}\t{span}\t255\n"
    )


def assemble_path(
    ctx: ConsensusContext,
    id2overlap: dict[tuple[int, int], tuple[int, int]],
    contain_elements: dict[int, list[ContainElement]],
    path: list[int],
    dig: DiGraph,
    asm_idx: int,
    writer: OutputWriter,
) -> None:
    """ap.cpp:615-1361 — consensus + emission for one linear path."""
    vdir = lambda vid: dig.vertex(vid).direction  # noqa: E731
    vlen = lambda vid: dig.vertex(vid).nanopore_length  # noqa: E731

    # -- stage 1: candidate DP ----------------------------------------------
    candidates = [_Candidate(set(), set(), 0.0, 0, [], [], [])]
    for a, b in zip(path, path[1:]):
        edge = dig.get_edge(a, b)
        next_candidates: list[_Candidate] = []
        for order in edge.orders:
            sub: list[_Candidate] = []
            for cand in candidates:
                base_score = cand.score + order.score
                ids = list(order.ids)
                if vdir(order.base) == Direction.NEG:
                    ids.reverse()
                edge_modifiers = [
                    x for x in ids if x not in cand.open_ids and x in cand.visited_ids
                ]
                sub.append(
                    _Candidate(
                        set(ids),
                        cand.visited_ids | set(ids),
                        base_score,
                        cand.kinks + len(edge_modifiers),
                        cand.edges + [edge],
                        cand.orders + [order],
                        cand.modifiers + [edge_modifiers],
                    )
                )
            mk, ms = _find_best(sub)
            next_candidates.extend(
                c for c in sub if mk is not None and c.kinks == mk and c.score == ms
            )
        candidates = next_candidates

    mk, ms = _find_best(candidates)
    best = next(c for c in candidates if c.kinks == mk and c.score == ms)

    # -- stage 2: anchor clustering (ap.cpp:708-719) ------------------------
    clusters: dict[int, list[int]] = {}
    for idx in range(len(best.edges)):
        for illu in best.orders[idx].ids:
            clusters.setdefault(illu, []).append(idx)

    cluster_modifier: list[dict[int, int]] = [dict() for _ in best.edges]
    for illu_base, edge_idx_list in clusters.items():
        get_cluster_anchors(
            ctx, cluster_modifier, id2overlap, illu_base, edge_idx_list, best.edges
        )

    # -- stage 3: per-vertex anchor ordering + adg (ap.cpp:721-853) ---------
    n_vertices = len(best.edges) + 1
    vertex_info: list[list] = [[] for _ in range(n_vertices)]
    vertices: list[int] = [0] * n_vertices
    match_modifiers: dict[int, int] = {}
    s = ctx.store
    for idx, edge in enumerate(best.edges):
        for m in best.modifiers[idx]:
            match_modifiers[m] = match_modifiers.get(m, 0) + 1
        ids = list(best.orders[idx].ids)
        if vdir(best.orders[idx].base) == Direction.NEG:
            ids.reverse()
        v_first, v_second = edge.v, edge.w
        for illu in ids:
            match = ((illu, cluster_modifier[idx].get(illu, 0)), match_modifiers.get(illu, 0))
            ra = ctx.vm(v_first, illu)
            vertex_info[idx].append(((int(s.nano_start[ra]), int(s.nano_end[ra])), match))
            rb = ctx.vm(v_second, illu)
            vertex_info[idx + 1].append(((int(s.nano_start[rb]), int(s.nano_end[rb])), match))
        vertices[idx] = v_first
        vertices[idx + 1] = v_second

    adg = DiGraph()
    registry: dict[tuple, int] = {}
    reg_idx2id: dict[int, tuple[int, int]] = {}
    anchor_sequences: dict[int, str] = {}
    nanopores: dict[Edge, list[int]] = {}
    pre_sequences: dict[int, list[str]] = {}
    post_sequences: dict[int, list[str]] = {}

    def anchor_id(match: tuple) -> int:
        if match not in registry:
            registry[match] = len(registry)
        return registry[match]

    def ensure_anchor(match: tuple, vtx: int, vdir_pos: bool) -> int:
        aid = anchor_id(match)
        if not adg.has_vertex(aid):
            adg.add_vertex(VertexInfo(aid))
            anchor_sequences[aid] = get_anchor_sequence(
                ctx, vtx, match[0][0], id2overlap[match[0]], vdir_pos
            )
            reg_idx2id[aid] = match[0]
        return aid

    for idx in range(n_vertices):
        info = vertex_info[idx]
        vtx = vertices[idx]
        vdir_pos = vdir(vtx) == Direction.POS

        def cmp(lhs, rhs, _vtx=vtx):
            if lhs[0] == rhs[0]:
                r = ctx.vm(_vtx, lhs[1][0][0])
                la, lb_ = id2overlap[lhs[1][0]], id2overlap[rhs[1][0]]
                if not s.direction[r]:
                    return -1 if lb_ < la else (1 if la < lb_ else 0)
                return -1 if la < lb_ else (1 if lb_ < la else 0)
            return -1 if lhs[0] < rhs[0] else 1

        info.sort(key=cmp_to_key(cmp))
        if vdir(vtx) == Direction.NEG:
            info.reverse()
        if not info:
            continue

        last_nr, last_match = info[0]
        for nr, match in info:
            ensure_anchor(match, vtx, vdir_pos)
            if match == last_match:
                continue
            laid = ensure_anchor(last_match, vtx, vdir_pos)
            aid = registry[match]

            flip = False
            if (last_nr[1] > nr[1] and last_nr[0] < nr[0]) or (
                last_nr[1] < nr[1] and last_nr[0] > nr[0]
            ):
                cn_left = get_corrected_nanopore_range(
                    ctx, vtx, last_match[0][0], id2overlap[last_match[0]]
                )
                cn_right = get_corrected_nanopore_range(
                    ctx, vtx, match[0][0], id2overlap[match[0]]
                )
                flip = (
                    vdir(vtx) == Direction.POS
                    and (
                        cn_left[0] > cn_right[0]
                        or (cn_left[0] == cn_right[0] and cn_left[1] > cn_right[1])
                    )
                ) or (
                    vdir(vtx) == Direction.NEG
                    and (
                        cn_left[0] < cn_right[0]
                        or (cn_left[0] == cn_right[0] and cn_left[1] < cn_right[1])
                    )
                )

            pair = (aid, laid) if flip else (laid, aid)
            e = adg.add_edge(*pair)
            nanopores.setdefault(e, []).append(vtx)

            last_match = match
            last_nr = nr

        first_match = info[0][1]
        pre_sequences.setdefault(registry[first_match], []).append(
            get_sequence_left_of_anchor(
                ctx, vtx, vlen(vtx), first_match[0][0], id2overlap[first_match[0]], vdir_pos
            )
        )
        second_match = info[-1][1]
        post_sequences.setdefault(registry[second_match], []).append(
            get_sequence_right_of_anchor(
                ctx, vtx, vlen(vtx), second_match[0][0], id2overlap[second_match[0]], vdir_pos
            )
        )

    # -- stage 4: inter-anchor alignment (ap.cpp:581-611,855-863) -----------
    distances: dict[Edge, int] = {}
    sequences: dict[Edge, list[str]] = {}
    for edge in adg.edges():
        seqs: list[str] = []
        global_distance: int | None = None
        for vtx in nanopores[edge]:
            dist, seq = get_sequence_between_anchors(
                ctx,
                vtx,
                reg_idx2id[edge.v][0],
                reg_idx2id[edge.w][0],
                id2overlap[reg_idx2id[edge.v]],
                id2overlap[reg_idx2id[edge.w]],
                vdir(vtx) == Direction.POS,
            )
            if seq is not None:
                seqs.append(seq)
            if global_distance is None:
                global_distance = dist
        distances[edge] = global_distance
        sequences[edge] = seqs

    # -- stage 5: topological placement sweep (ap.cpp:865-895) --------------
    order = adg.sort_topologically()
    if not order:  # fully cyclic adg — reference would crash; fall back
        FALLBACK_COUNTS["consensus_cyclic_adg_fallback"] += 1
        order = list(adg.vertices)
    v2order = {vid: i for i, vid in enumerate(order)}

    visited: dict[int, bool] = {}
    tap: dict[int, tuple[int, int]] = {}

    global_sequence, global_pos1, global_pos2 = visit_ordered(
        visited, tap, adg, reg_idx2id, v2order, order, distances, sequences,
        anchor_sequences, id2overlap, order[0],
    )

    adg_vertices = list(adg.vertices)
    if len(adg_vertices) == 1:
        anchor = adg_vertices[0]
        overlap = id2overlap[reg_idx2id[anchor]]
        tap[anchor] = (0, overlap[1] - overlap[0])
        global_sequence = ChunkedSeq(anchor_sequences[anchor])
        global_pos1 = 0
        global_pos2 = overlap[1] - overlap[0]

    # -- stage 6: merge disconnected sub-orders (ap.cpp:897-1010) -----------
    additional_paths: list[tuple[str | None, int, int, dict[int, tuple[int, int]]]] = []
    is_path_added: list[bool] = []
    for vid in order[1:]:
        if visited.get(vid, False):
            continue
        local_tap: dict[int, tuple[int, int]] = {}
        local_sequence, local_pos1, local_pos2 = visit_ordered(
            visited, local_tap, adg, reg_idx2id, v2order, order, distances,
            sequences, anchor_sequences, id2overlap, vid,
        )
        if not local_tap:
            overlap = id2overlap[reg_idx2id[vid]]
            local_tap[vid] = (0, overlap[1] - overlap[0])
            local_sequence = ChunkedSeq(anchor_sequences[vid])
            local_pos1 = 0
            local_pos2 = overlap[1] - overlap[0]
        additional_paths.append((local_sequence, local_pos1, local_pos2, local_tap))
        is_path_added.append(False)

    loop = True
    while loop:
        loop = False
        progressed = False
        for idx in range(len(additional_paths)):
            if is_path_added[idx]:
                continue
            local_sequence, local_pos1, local_pos2, local_tap = additional_paths[idx]
            group_offset = 0
            is_found = False

            for match_vid in local_tap:
                is_found = False
                succs = adg.successors(match_vid)
                for target in sorted(succs):
                    if target in tap:
                        pedge = succs[target]
                        group_offset = (
                            tap[target][0] - distances[pedge] - local_tap[match_vid][1] - 1
                        )
                        if sequences[pedge]:
                            local_sequence, local_pos1, local_pos2 = update_consensus_base(
                                local_sequence, (local_pos1, local_pos2),
                                sequences[pedge][0],
                                (
                                    local_tap[match_vid][1] + 1,
                                    local_tap[match_vid][1] + distances[pedge],
                                ),
                            )
                        is_found = True
                        break
                if is_found:
                    break

                preds = adg.predecessors(match_vid)
                for target in sorted(preds):
                    if target in tap:
                        pedge = preds[target]
                        group_offset = (
                            tap[target][1] + distances[pedge] + 1 - local_tap[match_vid][0] + 1
                        )
                        if sequences[pedge]:
                            local_sequence, local_pos1, local_pos2 = update_consensus_base(
                                local_sequence, (local_pos1, local_pos2),
                                sequences[pedge][0],
                                (
                                    local_tap[match_vid][0] - distances[pedge],
                                    local_tap[match_vid][0] - 1,
                                ),
                            )
                        is_found = True
                        break
                if is_found:
                    break

            if not is_found:
                loop = True
                continue

            progressed = True
            is_path_added[idx] = True
            for match_vid, span in local_tap.items():
                tap[match_vid] = (span[0] + group_offset, span[1] + group_offset)
            global_sequence, global_pos1, global_pos2 = update_consensus_base(
                global_sequence, (global_pos1, global_pos2), local_sequence,
                (local_pos1 + group_offset, local_pos2 + group_offset),
            )

        if loop and not progressed:
            # stranded sub-orders (anchors connecting only to other
            # unplaced paths) would spin forever — the reference has the
            # same hazard (ap.cpp:927-1010 re-scans unconditionally);
            # drop them rather than hang
            FALLBACK_COUNTS["consensus_stranded_suborder_drop"] += 1
            break

    # -- stage 7: longest pre/post flanks (ap.cpp:1012-1032) ----------------
    for vid in adg.vertices:
        if vid in pre_sequences:
            max_seq = max(pre_sequences[vid], key=len)
            global_sequence, global_pos1, global_pos2 = update_consensus_base(
                global_sequence, (global_pos1, global_pos2), max_seq,
                (tap[vid][0] - len(max_seq), tap[vid][0] - 1),
            )
        if vid in post_sequences:
            max_seq = max(post_sequences[vid], key=len)
            global_sequence, global_pos1, global_pos2 = update_consensus_base(
                global_sequence, (global_pos1, global_pos2), max_seq,
                (tap[vid][1] + 1, tap[vid][1] + len(max_seq)),
            )

    # -- stage 8: emission (ap.cpp:1034-1361) -------------------------------
    global_left_most = -global_pos1
    target_name = f"muchsalsa_{asm_idx}"
    target_len = len(global_sequence)
    width = ctx.sequence_line_length

    writer.write_target(
        f">{target_name}\n{wrap_sequence(global_sequence.materialize(), width)}\n"
    )

    query_idx = 0
    for edge in adg.edges():
        for seq in sequences[edge]:
            if not seq:
                continue
            name = f"Middle.{asm_idx}.{query_idx}"
            writer.write_query(f">{name}\n{wrap_sequence(seq, width)}\n")
            lb = tap[edge.v][1] + 1 + global_left_most
            rb = tap[edge.w][0] - 1 + global_left_most
            _write_paf_row(writer, name, len(seq), target_name, target_len, lb, rb)
            query_idx += 1

    for vid in adg.vertices:
        if vid in pre_sequences:
            for seq in pre_sequences[vid]:
                if len(seq) < ctx.th_sequence_length:
                    continue
                name = f"Left.{asm_idx}.{query_idx}"
                writer.write_query(f">{name}\n{wrap_sequence(seq, width)}\n")
                rb = tap[vid][0] - 1 + global_left_most
                lb = rb - len(seq) + 1
                _write_paf_row(writer, name, len(seq), target_name, target_len, lb, rb)
                query_idx += 1
        if vid in post_sequences:
            for seq in post_sequences[vid]:
                if len(seq) < ctx.th_sequence_length:
                    continue
                name = f"Right.{asm_idx}.{query_idx}"
                writer.write_query(f">{name}\n{wrap_sequence(seq, width)}\n")
                lb = tap[vid][1] + 1 + global_left_most
                rb = lb + len(seq) - 1
                _write_paf_row(writer, name, len(seq), target_name, target_len, lb, rb)
                query_idx += 1

    # contained-read expansion (ap.cpp:1227-1361)
    for idx in range(n_vertices):
        mapping_id2anchor: dict[int, tuple] = {}
        for info in vertex_info[idx]:
            mapping_id2anchor[info[1][0][0]] = info[1]

        vtx = vertices[idx]
        if vtx not in contain_elements:
            continue

        for ce in contain_elements[vtx]:
            contain_info = []
            for illu in sorted(ce.matches):
                if illu in mapping_id2anchor:
                    row = ce.matches[illu]
                    contain_info.append(
                        ((int(s.nano_start[row]), int(s.nano_end[row])), illu)
                    )
            if not contain_info:
                continue
            contain_info.sort()

            direction = ce.direction == (vdir(vtx) == Direction.POS)
            if not direction:
                contain_info.reverse()

            global_ranges: list[tuple[int, int]] = []
            skip_element = False
            for _nr, illu in contain_info:
                tap_id = mapping_id2anchor[illu]
                r = ctx.vm(vtx, illu)
                tap_dir = bool(s.direction[r]) == (vdir(vtx) == Direction.POS)
                ov = id2overlap[tap_id[0]]
                illumina_ref = ov[1] if tap_dir else ov[0]

                anchor_vid = registry.get(tap_id)
                if anchor_vid is None or anchor_vid not in tap:
                    # reference would throw .at() here; skip defensively
                    skip_element = True
                    break
                total_ref = tap[anchor_vid][1] + global_left_most

                crow = ce.matches[illu]
                cont_dir = bool(s.direction[crow]) == direction
                ir_s, ir_e = int(s.illu_start[crow]), int(s.illu_end[crow])
                if not cont_dir:
                    offset = ir_s - illumina_ref
                    global_ranges.append(
                        (total_ref - offset - (ir_e - ir_s), total_ref - offset)
                    )
                else:
                    offset = ir_e - illumina_ref
                    global_ranges.append(
                        (total_ref + offset - (ir_e - ir_s), total_ref + offset)
                    )
            if skip_element:
                continue

            seqs2write: list[tuple[str, int, int, str]] = []
            for gi in range(len(global_ranges)):
                illu = contain_info[gi][1]
                crow = ce.matches[illu]
                seqs2write.append(
                    (
                        ctx.illu_seq(
                            illu,
                            int(s.illu_start[crow]),
                            int(s.illu_end[crow]),
                            bool(s.direction[crow]) == direction,
                        ),
                        global_ranges[gi][0],
                        global_ranges[gi][1],
                        "Illumina_Match",
                    )
                )
                if gi == 0:
                    continue
                prev_row = ce.matches[contain_info[gi - 1][1]]
                seqs2write.append(
                    (
                        ctx.nano_seq(
                            ce.nano,
                            int(s.nano_end[prev_row]) + 1,
                            int(s.nano_start[crow]) - 1,
                            direction,
                        ),
                        global_ranges[gi - 1][1] + 1,
                        global_ranges[gi][0] - 1,
                        "Nano_Middle",
                    )
                )

            for seq, lb, rb, label in seqs2write:
                if len(seq) < ctx.th_sequence_length:
                    continue
                name = f"Contain_{label}.{asm_idx}.{query_idx}"
                writer.write_query(f">{name}\n{wrap_sequence(seq, width)}\n")
                _write_paf_row(writer, name, len(seq), target_name, target_len, lb, rb)
                query_idx += 1
