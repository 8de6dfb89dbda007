"""Myers bit-parallel edit distance over Python big ints: the host oracle.

The port's copy of ``myers_bigint`` from ``muchsalsa_tpu/ops/myers.py``
(:31), the reference the edit-distance kernels' checks compare with.  It
counts an ``N`` against an ``N`` as a match, unlike the kernels' PEq.
"""

from __future__ import annotations


def myers_bigint(q: bytes, t: bytes) -> int:
    """Myers 1999 bit-vector edit distance, pattern as one big int."""
    m = len(q)
    n = len(t)
    if m == 0:
        return n
    if n == 0:
        return m

    peq = {c: 0 for c in set(q) | set(t)}
    for i, c in enumerate(q):
        peq[c] = peq.get(c, 0) | (1 << i)

    mask = (1 << m) - 1
    high = 1 << (m - 1)
    vp = mask
    vn = 0
    score = m

    for c in t:
        eq = peq.get(c, 0)
        xv = eq | vn
        xh = (((eq & vp) + vp) ^ vp) | eq

        ph = vn | (~(xh | vp) & mask)
        mh = vp & xh

        if ph & high:
            score += 1
        elif mh & high:
            score -= 1

        ph = ((ph << 1) | 1) & mask
        mh = (mh << 1) & mask

        vp = mh | (~(xv | ph) & mask)
        vn = ph & xv

    return score
