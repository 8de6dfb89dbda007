"""Plain edit distance: the Levenshtein matrix filled row by row.

``distance`` takes pairs of code sequences (A, C, G, T = 0..3; any other
code matches nothing, itself included) and returns D[m][n], the fewest
substitutions, insertions and deletions that turn one into the other.  Row i
of the matrix is ``min(D[i-1][j-1] + cost, D[i-1][j] + 1)`` followed by the
in-row chain ``D[i][j] = min(D[i][j], D[i][j-1] + 1)``, which is a running
minimum of ``row[j] - j`` plus j.  Pairs go in blocks, each block one
(pairs, columns) tensor a row.

This file imports nothing of the program.
"""

from __future__ import annotations

import torch


def _block(q: torch.Tensor, qn: torch.Tensor, t: torch.Tensor, tn: torch.Tensor) -> torch.Tensor:
    """D[qn][tn] of each pair of a block: ``q`` (P, M), ``t`` (P, N) codes
    padded with anything, ``qn``, ``tn`` their lengths."""
    P, M = q.shape
    N = t.shape[1]
    dev = q.device
    j = torch.arange(N + 1, device=dev, dtype=torch.int32)
    row = j.expand(P, N + 1).clone()
    out = tn.to(torch.int32).clone()              # D[0][n] = n
    t_at = tn.long()[:, None]
    t_bad = t >= 4
    for i in range(1, M + 1):
        qi = q[:, i - 1 : i]
        cost = ((t != qi) | t_bad | (qi >= 4)).to(torch.int32)
        cand = torch.minimum(row[:, :-1] + cost, row[:, 1:] + 1)
        cand = torch.cat([torch.full((P, 1), i, dtype=torch.int32, device=dev), cand], 1)
        row = torch.cummin(cand - j, 1).values + j
        out = torch.where(qn == i, row.gather(1, t_at)[:, 0], out)
    return out


def distance(q: torch.Tensor, qn: torch.Tensor, t: torch.Tensor, tn: torch.Tensor,
             cells: int = 1 << 27) -> torch.Tensor:
    """Edit distance of each pair: ``q`` (P, M) and ``t`` (P, N) codes,
    ``qn``, ``tn`` (P,) lengths, all on one device; blocks of pairs hold at
    most about ``cells`` matrix cells a row.  Returns (P,) int32 there."""
    P = q.shape[0]
    out = torch.zeros(P, dtype=torch.int32, device=q.device)
    rows = max(cells // (t.shape[1] + 1), 1)
    for s in range(0, P, rows):
        e = min(s + rows, P)
        M = int(qn[s:e].max())
        N = int(tn[s:e].max())
        out[s:e] = _block(q[s:e, :M], qn[s:e], t[s:e, :N], tn[s:e])
    return out
