"""Coverage-outlier unitig correction.

Reference counterpart: ``pipeline/unitig_filter.py`` (LazyB): per
unitig, build the nanopore coverage profile from PAF hits (one hit per
distinct read, ``unitig_filter.py:53-58``), flag unitigs whose max
coverage exceeds Q3 + 1.5*IQR of all max-coverages, and cut flagged
unitigs into fragments where coverage <= Q3 with length >= 500
(``unitig_filter.py:102-127``).  Vectorised with diff-array coverage
accumulation instead of per-base Python loops.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class UnitigStats:
    cutoff: float
    q3: float
    all_count: int
    outlier_count: int
    rescued_count: int


def _parse_paf(paf_lines):
    """Yield (illu_id, illu_len, start, end_inclusive, nano_id)."""
    for line in paf_lines:
        if not line:
            continue
        c = line.split("\t")
        yield c[0], int(c[1]), int(c[2]), int(c[3]) - 1, c[5]


def coverage_profiles(paf_lines) -> dict[str, np.ndarray]:
    """Per-unitig coverage from distinct-read hits (first hit per read)."""
    profiles: dict[str, np.ndarray] = {}
    seen: dict[str, set] = {}
    for illu, ilen, s, e, nano in _parse_paf(paf_lines):
        if illu not in profiles:
            profiles[illu] = np.zeros(ilen + 1, dtype=np.int32)
            seen[illu] = set()
        if nano in seen[illu]:
            continue
        seen[illu].add(nano)
        profiles[illu][s] += 1
        profiles[illu][e + 1] -= 1
    return {k: np.cumsum(v[:-1]) for k, v in profiles.items()}


def filter_unitigs(
    paf_lines: list[str],
    unitig_seqs: dict[str, bytes],
    iqr_multiplier: float = 1.5,
    min_fragment: int = 500,
) -> tuple[list[tuple[str, bytes]], UnitigStats]:
    """Returns (corrected unitig records, stats)."""
    profiles = coverage_profiles(paf_lines)
    if not profiles:
        return [(n, s) for n, s in unitig_seqs.items()], UnitigStats(0, 0, 0, 0, 0)

    max_cov = {k: int(v.max()) if len(v) else 0 for k, v in profiles.items()}
    values = np.array(list(max_cov.values()), dtype=np.float64)
    q1 = np.percentile(values, 25)
    q3 = np.percentile(values, 75)
    cutoff = q3 + iqr_multiplier * (q3 - q1)

    out: list[tuple[str, bytes]] = []
    outliers = rescued = 0
    # iterate in PAF first-appearance order like the reference's block scan
    order = list(profiles)
    for name in order:
        seq = unitig_seqs.get(name)
        if seq is None:
            continue
        if max_cov[name] > cutoff:
            outliers += 1
            profile = profiles[name]
            fragments = _cut_peaks(profile, q3, min_fragment)
            if fragments:
                rescued += 1
            for i, (s, e) in enumerate(fragments):
                out.append((f"{name}_{i} {e - s + 1} {s} {e}", seq[s : e + 1]))
        else:
            out.append((name, seq))

    stats = UnitigStats(float(cutoff), float(q3), len(order), outliers, rescued)
    return out, stats


def _cut_peaks(profile: np.ndarray, q3: float, min_fragment: int) -> list[tuple[int, int]]:
    """Maximal runs with coverage <= q3, length >= min_fragment
    (unitig_filter.py:102-127; returned bounds inclusive)."""
    below = profile <= q3
    fragments = []
    start = None
    for i, b in enumerate(below):
        if b and start is None:
            start = i
        elif not b and start is not None:
            if i - start >= min_fragment:
                fragments.append((start, i - 1))
            start = None
    if start is not None and len(below) - start >= min_fragment:
        fragments.append((start, len(below) - 1))
    return fragments
