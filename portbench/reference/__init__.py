"""The plain reference of a map-stage job: the PAF lines that the port's
``map_all`` has to produce for the same unitigs, reads and mapper settings.

``paf`` builds its own index from the unitigs (``mapper.build_index``), maps
every read (``mapper.map_all_reads``) and, where the job refines, replaces
each mapping's matches by ``max(len q, len t) - d``, d the exact edit
distance of the mapped unitig range and read range, the read range reverse
complemented on the minus strand (``edit.distance``).  Where a ``sample``
is given, only the mappings it picks are refined; the others' matches read
``*``, a field the comparison leaves out.

Nothing here imports the program or takes anything it made.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import edit
from portbench.reference.mapper import (FIELDS, UNCHECKED, Mappings, Params, build_index,
                                        map_all_reads, paf_lines)


def _pairs(m: Mappings, s: int, e: int, u_codes, u_off, r_codes, r_off):
    """Padded (query, target) codes of mappings s..e on the codes' device:
    the unitig range, and the read range reverse complemented where the
    mapping is on the minus strand."""
    dev = u_codes.device
    qs, qe = m.q_start[s:e], m.q_end[s:e]
    ts, te = m.t_start[s:e], m.t_end[s:e]
    qn, tn = qe - qs, te - ts
    jq = torch.arange(int(qn.max()), device=dev)
    jt = torch.arange(int(tn.max()), device=dev)
    q_at = u_off[m.unitig[s:e], None] + qs[:, None] + jq
    q = torch.where(jq < qn[:, None], u_codes[q_at.clamp(max=len(u_codes) - 1)], 5)
    fwd = m.strand[s:e, None]
    base = r_off[m.read[s:e], None]
    t_at = torch.where(fwd, base + ts[:, None] + jt, base + te[:, None] - 1 - jt)
    t = r_codes[t_at.clamp(min=0, max=len(r_codes) - 1)]
    t = torch.where(fwd | (t >= 4), t, 3 - t)
    t = torch.where(jt < tn[:, None], t, 4)
    return q, qn, t, tn


def refined_matches(m: Mappings, u_codes, u_off, r_codes, r_off, block: int = 1 << 17):
    """``max(len q, len t) - d`` of every mapping, ``block`` mappings at a
    time, on the codes' device."""
    out = torch.zeros_like(m.matches)
    for s in range(0, len(m.read), block):
        e = min(s + block, len(m.read))
        q, qn, t, tn = _pairs(m, s, e, u_codes, u_off, r_codes, r_off)
        d = edit.distance(q, qn, t, tn)
        out[s:e] = torch.maximum(qn, tn) - d.long()
    return out


def paf(inputs, params: Params, refine: bool, device, unitig_name, read_name,
        sample=None) -> list[str]:
    """The job's PAF lines by the reference, computed on ``device``;
    ``sample(n)``, where given, picks the indices of the n mappings whose
    refinement is checked."""
    dev = torch.device(device)
    u_codes = torch.from_numpy(inputs.unitig_codes).to(dev)
    u_off = torch.from_numpy(inputs.unitig_offsets).to(dev)
    r_codes = torch.from_numpy(inputs.read_codes).to(dev)
    r_off = torch.from_numpy(inputs.read_offsets).to(dev)
    index = build_index(u_codes, u_off, params)
    m = map_all_reads(index, r_codes, r_off, params)
    del index
    if refine and len(m.read):
        n = len(m.read)
        pick = torch.arange(n) if sample is None else torch.from_numpy(sample(n)).long()
        pick = pick.to(dev)
        # shortest unitig range first, so each block's rows stop near its own longest
        pick = pick[torch.argsort(m.q_end[pick] - m.q_start[pick])]
        some = Mappings(*(getattr(m, f)[pick] for f in FIELDS))
        m.matches = torch.full_like(m.matches, UNCHECKED)
        m.matches[pick] = refined_matches(some, u_codes, u_off, r_codes, r_off)
    return paf_lines(m, np.diff(inputs.unitig_offsets), np.diff(inputs.read_offsets),
                     unitig_name, read_name)
