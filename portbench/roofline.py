"""The card's peaks and the bound of the exact-Myers kernel, frozen here so
that the yardstick does not move with the program.

The arithmetic is that of ``muchsalsa_tpu_torch/utils/roofline.py``: a
bound is the larger of the bytes a call must move over the memory rate and
the operations it does over the peak rate for their type.  The memory rate
is NVIDIA's data sheet for the H100 SXM; the int32 rate is read off the
card: 64 int32 operations a clock on each SM, times the SM count, times the
maximum SM clock that ``nvidia-smi`` reports.
"""

from __future__ import annotations

import os
import subprocess

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT32_OPS_PER_CLK_SM = 64      # Hopper's int32 issue rate
MYERS_OPS = 15                 # int32 ops of one (text column, pattern word) Myers step
WORD_BITS = 32


def smi_index() -> int:
    """``nvidia-smi``'s index of the process's first card: the first of
    ``CUDA_VISIBLE_DEVICES`` where that names one by number."""
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    return int(first) if first.isdigit() else 0


def smi(query: str) -> str | None:
    """One ``nvidia-smi --query-gpu`` field of the process's first card, or
    None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits",
             "-i", str(smi_index())], capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def card_int32_rate(sm_count: int) -> float | None:
    """int32 operations a second of the card, or None where its clock
    cannot be read."""
    clock = smi("clocks.max.sm")
    if clock is None:
        return None
    return INT32_OPS_PER_CLK_SM * sm_count * float(clock) * 1e6


def myers_full_work(q_lens: list[int], t_lens: list[int]) -> tuple[int, int]:
    """(bytes, int32 ops) of one exact-Myers call on a packed batch of these
    query and target lengths: the padded codes and the lengths read once,
    the distances written once; 15 ops a (column, word) step over each
    problem's own columns and words."""
    P = len(q_lens)
    if P == 0:
        return 0, 0
    M, N = max(max(q_lens), 1), max(max(t_lens), 1)
    nbytes = P * (M + N) + 12 * P
    ops = MYERS_OPS * sum((m + WORD_BITS - 1) // WORD_BITS * n for m, n in zip(q_lens, t_lens))
    return nbytes, ops


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    """The least seconds for moving ``nbytes`` and doing ``ops``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)
