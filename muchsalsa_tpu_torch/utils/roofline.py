"""The card's peak rates, each kernel's bound on given inputs, and the timers
that measure a kernel against it.

A bound is the least time the card could take for a call's work: the larger
of the bytes the function must move (each input read once, each output
written once) over the memory rate, and the operations it does on these
inputs over the peak rate for their type.  Rates are those of one NVIDIA
H100 SXM (NVIDIA's data sheet), except the int32 rate, which is read off
the card itself: ``INT32_OPS_PER_CLK_SM`` times its SM count times its
maximum SM clock (``card_int32_rate``).  Where the work depends on the data
(a problem's own lengths, a band that refuses a problem), the operations
count what these inputs need.

``chip_smoke.py``, ``muchsalsa_tpu_torch.bench`` and the A/B scripts under
``scripts/`` all take their bounds from here.
"""

from __future__ import annotations

import statistics
import subprocess
import warnings

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP64_FLOPS = 34e12             # H100 SXM data sheet, outside the tensor cores
INT32_OPS_PER_CLK_SM = 64      # Hopper's int32 issue rate
MYERS_OPS = 15                 # int32 ops of one (column, word) Myers step
WAVEFRONT_OPS = 3              # int32 issue slots of one wavefront band cell: the cost's
                               # compare, then min(S[x+1] + 2, left) and min(S[x] + cost, .),
                               # one DPX add-min each on sm_90a (the recurrence's 5 ops)
DP_PAIR_OPS = 35               # float64 compares and adds of one chain_dp pair test


def card_int32_rate() -> tuple[int, float, float]:
    """(SM count, maximum SM clock in MHz, int32 ops/s) of CUDA card 0, the
    clock as ``nvidia-smi --query-gpu=clocks.max.sm`` gives it."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    return sms, clock_mhz, INT32_OPS_PER_CLK_SM * sms * clock_mhz * 1e6


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """The least time (ms) for moving ``nbytes`` at the card's memory rate
    and doing ``ops`` at ``ops_per_s``, and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_bound(B: int, K: int) -> tuple[float, str]:
    """chain_scan at (B, K): compat (1 byte a pair), init and scores (f64),
    backpointers (int32); a compare and an add in f64 per pair k < l."""
    return bound(B * K * K + B * K * (8 + 8 + 4), B * K * (K - 1), FP64_FLOPS)


def dp_bytes(anchors: int, B: int, K: int) -> int:
    """Bytes chain_dp must move on a packed batch of ``anchors`` anchors in B
    problems of at most K: each anchor's 13 float64 fields and flag byte and
    the B + 1 int32 offsets read once, every slot's score (f64) and
    backpointer (int32) written once."""
    return anchors * (13 * 8 + 1) + 4 * (B + 1) + B * K * (8 + 4)


def dp_bound(offsets: torch.Tensor, K: int) -> tuple[float, str]:
    """chain_dp on a packed batch of B problems of at most K anchors, cut by
    ``offsets``: ``dp_bytes``, and DP_PAIR_OPS float64 ops a pair test of two
    anchors k < l of a problem and a compare and an add a scan candidate."""
    n = (offsets[1:] - offsets[:-1]).double()
    B, N = n.numel(), int(n.sum())
    pairs = float((n * (n - 1) / 2).sum())
    return bound(dp_bytes(N, B, K), pairs * (DP_PAIR_OPS + 2), FP64_FLOPS)


def align_work(name: str, args, kw: dict) -> tuple[int, int]:
    """(bytes, int32 ops) of one edit-distance call on the packed batch
    ``args`` (q_codes, q_lens, t_codes, t_lens): every code and length read
    once, the distances written once; the ops of the work these lengths
    need, since the kernels stop at each problem's end: ``myers_full`` 15
    a (column, word) step, ``myers_banded`` 15 a step of each of its
    ``kw["window_words"]`` words over the columns of the problems inside
    the band, ``banded_wavefront`` ``WAVEFRONT_OPS`` a band cell of the
    rows of the problems inside ``kw["band"]``."""
    from muchsalsa_tpu_torch.ops.myers_torch import geometry

    q, ql, t, tl = args
    m, n = ql.long(), tl.long()
    nbytes = q.numel() + t.numel() + 12 * q.shape[0]
    if name == "myers_full":
        ops = MYERS_OPS * int(((m + 31) // 32 * n).sum())
    elif name == "myers_banded":
        wb = kw["window_words"]
        klo, khi, _h = geometry(wb)
        diff = n - m
        in_band = (diff - klo >= 32) & (khi - diff >= 32) & (m > 0) & (n > 0)
        ops = MYERS_OPS * wb * int(torch.where(in_band, n, 0).sum())
    elif name == "banded_wavefront":
        band = kw["band"]
        ok = ((n - m).abs() < band) & (m > 0) & (n > 0)
        ops = WAVEFRONT_OPS * band * int(torch.where(ok, m, 0).sum())
    else:
        raise ValueError(f"no edit-distance kernel named {name!r}")
    return nbytes, ops


def gather_bytes(q_len: torch.Tensor, t_len: torch.Tensor, M: int, N: int) -> int:
    """Bytes ``gather_problems`` must move: each problem's range of the two
    blobs (its lengths' bytes) and its coordinates (an offset and a start,
    int64, and a length, int32, a side; the strand byte) read once, and the
    P (M + N) codes written once."""
    P = q_len.numel()
    return int(q_len.sum()) + int(t_len.sum()) + P * (2 * (8 + 8 + 4) + 1) + P * (M + N)


def gather_bound(q_len: torch.Tensor, t_len: torch.Tensor, M: int, N: int) -> tuple[float, str]:
    """Bound of one ``gather_problems`` call: its bytes (``gather_bytes``);
    a table lookup a code is far below any issue rate."""
    return bound(gather_bytes(q_len, t_len, M, N), 0, 1.0)


def align_bound(name: str, args, kw: dict, int32_ops_per_s: float) -> tuple[float, str]:
    """Bound of one edit-distance call on these inputs (``align_work``)."""
    return bound(*align_work(name, args, kw), int32_ops_per_s)


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of one call, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_ms(fn, names: tuple[str, ...], calls: int = 5) -> float | None:
    """Device time (ms) a call of the CUDA kernels whose names hold one of
    ``names``, from ``torch.profiler`` over ``calls`` calls; None where the
    profiler saw no device time for them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings():
        # each profile is one cycle: its note that events clear between cycles does not apply
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    averages = prof.key_averages()
    col = ("self_device_time_total" if averages and hasattr(averages[0], "self_device_time_total")
           else "self_cuda_time_total")
    total = sum(getattr(e, col) for e in averages
                if e.device_type == DeviceType.CUDA and any(s in e.key for s in names))
    return total / calls / 1e3 or None
