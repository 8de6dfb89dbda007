"""The program's spans as the benchmark reads them.

The map stage records each piece of its work in a span
(``muchsalsa_tpu_torch/utils/timing.py``: ``StageTimer``, the names in
``SPANS``) and ``map_all`` puts each span's summed seconds and count into
its stats as ``<span>_s`` and ``<span>_n``, which a ``Job`` keeps.
``job_mean`` is what the metric readers of those spans share: a program from
before its spans has no such keys, and they read nothing there.

While ``torch.profiler`` runs, each span is also a range of the trace on
the card's clock.  ``attribute`` puts the card's idle time in the traced
window down to the innermost span, the program's or the benchmark's
(``window``, ``job.*``), around it.  Run on one cell:

    python3 -m portbench.spans --workload NAME --seed N --seconds S

prints that attribution as one JSON line, then the benchmark's own traced
result line (``portbench.run --trace 1``) of the same run.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def job_mean(run, names, minus=(), jobs=None):
    """The mean over ``jobs`` (by default the window's jobs that ran any of
    the spans ``names``) of the seconds of ``names`` less the seconds of
    ``minus``; None where there is no such job."""
    if jobs is None:
        jobs = [j for j in run.jobs if any(f"{n}_n" in j.stats for n in names)]
    if not jobs:
        return None
    total = 0.0
    for j in jobs:
        total += sum(j.stats.get(f"{n}_s", 0.0) for n in names)
        total -= sum(j.stats.get(f"{n}_s", 0.0) for n in minus)
    return total / len(jobs)


def program_spans() -> tuple[str, ...]:
    """The program's span names; none where the program has no spans."""
    try:
        from muchsalsa_tpu_torch.utils.timing import SPANS
    except ImportError:
        return ()
    return SPANS


def trace_rows(prof) -> list[tuple[str, str, int, int]]:
    """(name, device type, start ns, end ns) of every event of a stopped
    ``torch.profiler`` profile, as ``harness.read_trace`` reads them."""
    try:
        return [(e.name(), str(e.device_type()), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events()]
    except AttributeError:
        return [(e.key, str(e.device_type), int(e.time_range.start * 1000),
                 int(e.time_range.end * 1000)) for e in prof.events()]


def innermost(spans, w0: int, w1: int) -> list[tuple[int, int, str]]:
    """``[w0, w1]`` cut into (start, end, name) pieces, each named by the
    innermost of ``spans`` ((start, end, name), nested as ranges of one
    thread are) around it, ``window`` where none is."""
    pieces = []
    stack = [(w0, w1, "window")]
    cursor = w0
    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        while stack[-1][1] <= s:
            _s, end, name = stack.pop()
            pieces.append((cursor, end, name))
            cursor = end
        pieces.append((cursor, s, stack[-1][2]))
        cursor = s
        stack.append((s, min(e, stack[-1][1]), n))
    while stack:
        _s, end, name = stack.pop()
        pieces.append((cursor, end, name))
        cursor = end
    return [p for p in pieces if p[1] > p[0]]


def attribute(rows, program=None) -> dict:
    """The card's busy and idle time in the traced window of ``rows``
    (``trace_rows``): ``busy_s``, ``window_s``, ``device_idle`` (%),
    ``idle_gaps`` (the ten longest, each named by the innermost span at its
    middle), ``idle_by_span`` (all idle seconds by innermost span, a gap
    split where spans begin or end) and ``idle_unlabelled`` (the share of
    idle time inside ``job.map_all`` that no program span covers, %).  The
    profiler's mirrors of the spans on the card's timeline are left out of
    the card's work."""
    program = program_spans() if program is None else program
    window = [(s, e) for n, d, s, e in rows if n == "window" and "CPU" in d]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window[0]
    labels = set(program)
    spans = [(s, e, n) for n, d, s, e in rows
             if "CPU" in d and (n.startswith("job.") or n in labels)]
    mirrors = {"window"} | labels | {n for _s, _e, n in spans}
    device = sorted((max(s, w0), min(e, w1)) for n, d, s, e in rows
                    if "CUDA" in d and n not in mirrors and e > w0 and s < w1)
    busy, gaps, cursor = 0, [], w0
    for s, e in device:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if w1 > cursor:
        gaps.append((cursor, w1))

    pieces = innermost(spans, w0, w1)
    starts = [p[0] for p in pieces]
    by_span: dict[str, float] = {}
    k = 0
    for a, b in gaps:
        while pieces[k][1] <= a:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < b:
            s, e, n = pieces[j]
            by_span[n] = by_span.get(n, 0.0) + (min(b, e) - max(a, s)) / 1e9
            j += 1

    def label(t):
        return pieces[max(bisect.bisect_right(starts, t) - 1, 0)][2]

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    inside = by_span.get("job.map_all", 0.0) + sum(by_span.get(n, 0.0) for n in program)
    window_s = (w1 - w0) / 1e9
    return {
        "busy_s": busy / 1e9, "window_s": window_s,
        "device_idle": 100.0 * (1.0 - busy / (w1 - w0)),
        "idle_gaps": [[label((a + b) / 2), (b - a) / 1e9] for a, b in longest],
        "idle_by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
        "idle_unlabelled": (100.0 * by_span.get("job.map_all", 0.0) / inside) if inside else None,
    }


def main(argv=None) -> None:
    from portbench import run as bench_run

    bench_run._caches()
    import torch

    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(harness.THREADS)
    if not torch.cuda.is_available():
        bench_run._fail("no CUDA card: torch.cuda.is_available() is False")
    bench = harness.load_benchmark()
    run = harness.Run(*harness.cell_parts(bench, args.workload), args.seed, "cuda")
    kept = {}
    read_trace = harness.read_trace

    def keep_rows(prof):   # read_trace reads the rows and keeps none of them
        kept["rows"] = trace_rows(prof)
        return read_trace(prof)

    harness.read_trace = keep_rows
    harness.run_window(run, args.seconds, True, T_START)
    out = attribute(kept["rows"])
    out["spans_a_job"] = [sum(v for k, v in j.stats.items() if k.endswith("_n"))
                          for j in run.jobs]
    print(json.dumps(out))
    sys.stdout.flush()
    bench_run.finish(run, bench, True)


if __name__ == "__main__":
    main()
