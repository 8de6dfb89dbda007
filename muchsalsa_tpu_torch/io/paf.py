"""PAF ("BLAST file") ingest -> dense numpy record table.

Reference counterpart: ``BlastFileAccessor`` + ``BlastFileReader``
(``libms/src/BlastFileReader.cpp:86-130``).  Column mapping (PAF):

    0 qname  -> illumina (unitig) id        [POS_IID]
    2 qstart -> illumina range start        [POS_IRS]
    3 qend   -> illumina range end, stored end-1 (inclusive)  [POS_IRE]
    4 strand -> direction ('+' == True)     [POS_DIR]
    5 tname  -> nanopore id                 [POS_NID]
    6 tlen   -> nanopore length             [POS_NLE]
    7 tstart -> nanopore range start        [POS_NRS]
    8 tend   -> nanopore range end, stored end-1 (inclusive)  [POS_NRE]
    9 nmatch -> match count / score         [POS_NOM]

Filters (``BlastFileReader.cpp:106-107,121-122``): a line becomes a
match iff ``matches >= min_matches`` and ``illu_len >= min_matches``;
it is *primary* iff ``illu_len >= th_length`` and ``matches >= th_matches``.

Parity quirk: the reference's read loop stops at ``lineCount - 1``
(``BlastFileReader.cpp:76``), silently dropping the final PAF line;
``skip_last_line`` reproduces that behavior (on by default via config).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from muchsalsa_tpu_torch.io.registry import Registry


@dataclass
class PafRecords:
    """Filtered match lines in struct-of-arrays form (one row per kept line)."""

    illu_id: np.ndarray   # int32
    nano_id: np.ndarray   # int32
    illu_start: np.ndarray  # int32
    illu_end: np.ndarray    # int32, inclusive (PAF end - 1)
    nano_start: np.ndarray  # int32
    nano_end: np.ndarray    # int32, inclusive (PAF end - 1)
    nano_length: np.ndarray  # int32, per row
    direction: np.ndarray   # bool
    score: np.ndarray       # int64 (match count)
    is_primary: np.ndarray  # bool
    line_idx: np.ndarray    # int64 (0-based PAF line number)

    registry_nanopore: Registry
    registry_illumina: Registry

    def __len__(self) -> int:
        return len(self.line_idx)

    @property
    def rratio(self) -> np.ndarray:
        """Illumina-/nanopore-range length ratio (``BlastFileReader.cpp:118-119``)."""
        illu_len = self.illu_end - self.illu_start + 1
        nano_len = self.nano_end - self.nano_start + 1
        return illu_len.astype(np.float64) / nano_len.astype(np.float64)


def read_paf(
    path: str | Path,
    *,
    min_matches: int = 400,
    th_length: int = 500,
    th_matches: int = 500,
    skip_last_line: bool = True,
    registry_nanopore: Registry | None = None,
    registry_illumina: Registry | None = None,
    use_native: bool = True,
) -> PafRecords:
    reg_nano = registry_nanopore if registry_nanopore is not None else Registry()
    reg_illu = registry_illumina if registry_illumina is not None else Registry()

    if use_native:
        from muchsalsa_tpu_torch import native

        if native.available():
            parsed = native.parse_paf(Path(path).read_bytes(), min_matches, skip_last_line)
            if parsed is not None:
                arrays, nano_names, illu_names = parsed
                nano_map = np.array([reg_nano[n] for n in nano_names], dtype=np.int32)
                illu_map = np.array([reg_illu[n] for n in illu_names], dtype=np.int32)
                illu_len = arrays["illu_end"] - arrays["illu_start"] + 1
                is_primary = (illu_len >= th_length) & (arrays["score"] >= th_matches)
                return PafRecords(
                    illu_id=illu_map[arrays["illu_id"]] if len(illu_map) else arrays["illu_id"],
                    nano_id=nano_map[arrays["nano_id"]] if len(nano_map) else arrays["nano_id"],
                    illu_start=arrays["illu_start"],
                    illu_end=arrays["illu_end"],
                    nano_start=arrays["nano_start"],
                    nano_end=arrays["nano_end"],
                    nano_length=arrays["nano_length"],
                    direction=arrays["direction"],
                    score=arrays["score"],
                    is_primary=is_primary,
                    line_idx=arrays["line_idx"],
                    registry_nanopore=reg_nano,
                    registry_illumina=reg_illu,
                )

    illu_ids: list[int] = []
    nano_ids: list[int] = []
    cols_i32: list[tuple[int, int, int, int, int]] = []
    dirs: list[bool] = []
    scores: list[int] = []
    lines_kept: list[int] = []

    data = Path(path).read_bytes()
    lines = data.split(b"\n")
    # Drop a trailing empty chunk from a final newline, then optionally the
    # true last data line (reference off-by-one, see module docstring).
    while lines and lines[-1] == b"":
        lines.pop()
    n_lines = len(lines)
    limit = n_lines - 1 if skip_last_line else n_lines

    for line_no in range(limit):
        line = lines[line_no]
        if not line:
            continue
        t = line.split(b"\t")
        if len(t) < 10:
            raise ValueError(f"Invalid PAF line {line_no}: fewer than 10 columns")
        illu_start = int(t[2])
        illu_end = int(t[3]) - 1
        matches = int(t[9])
        illu_len = illu_end - illu_start + 1
        if matches < min_matches or illu_len < min_matches:
            continue
        illu_ids.append(reg_illu[t[0].decode()])
        nano_ids.append(reg_nano[t[5].decode()])
        cols_i32.append((illu_start, illu_end, int(t[7]), int(t[8]) - 1, int(t[6])))
        dirs.append(t[4] == b"+")
        scores.append(matches)
        lines_kept.append(line_no)

    arr = np.array(cols_i32, dtype=np.int32).reshape(-1, 5)
    score_arr = np.array(scores, dtype=np.int64)
    illu_len_arr = arr[:, 1] - arr[:, 0] + 1
    is_primary = (illu_len_arr >= th_length) & (score_arr >= th_matches)

    return PafRecords(
        illu_id=np.array(illu_ids, dtype=np.int32),
        nano_id=np.array(nano_ids, dtype=np.int32),
        illu_start=arr[:, 0].copy(),
        illu_end=arr[:, 1].copy(),
        nano_start=arr[:, 2].copy(),
        nano_end=arr[:, 3].copy(),
        nano_length=arr[:, 4].copy(),
        direction=np.array(dirs, dtype=bool),
        score=score_arr,
        is_primary=is_primary,
        line_idx=np.array(lines_kept, dtype=np.int64),
        registry_nanopore=reg_nano,
        registry_illumina=reg_illu,
    )
