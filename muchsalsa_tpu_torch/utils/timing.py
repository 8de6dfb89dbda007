"""Stage timers and spans + lightweight structured logging.

TPU equivalent of the reference's TRACE macro / wall-clock prints
(``include/ms/Debug.h:28-32``, ``pipeline/pipeline.sh:110``): per-stage
host timers, plus optional ``torch.profiler`` trace capture around a stage.

The port's copy of ``StageTimer`` from ``muchsalsa_tpu/utils/timing.py``
(:19-45), grown into the port's one span mechanism: a span
(``timer.stage(name)``) adds its seconds and one call under its name, and
the span open around it when it opens is its parent.  While a
``torch.profiler`` is recording, a span is also a range of the profiler's
trace, so it lies on the clock of the card's activity; otherwise it enters
nothing of the profiler.  ``torch_profile`` takes the place of
``jax_profile`` (:71-83).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field

import torch

# the map stage's spans (``pipeline/mapper_torch.py``), one name each;
# readers of the benchmark and the tests take the names from here
SPANS = (
    "map.v2_tables", "map.v1_tables", "map.read_pack", "map.dispatch", "map.wait",
    "map.collect", "map.repull", "map.tier1", "map.tier2", "map.host", "map.paf",
    "refine.pairs", "refine.pad", "refine.copy", "refine.distance", "refine.writeback",
)


def _profiler_range(name: str):
    """A range of the running profiler's trace.  Of function scope: the
    profiler mirrors a user-scope range (``torch.profiler.record_function``)
    on the card's timeline as an annotation over the kernels launched in it,
    which a reader of that timeline would count as card work."""
    return torch._C._profiler._RecordFunctionFast(name)


class _Span:
    """One span of a ``StageTimer``; ``seconds`` holds its wall once it has
    closed."""

    __slots__ = ("timer", "name", "range", "t0", "seconds")

    def __init__(self, timer: StageTimer, name: str):
        self.timer, self.name, self.seconds = timer, name, 0.0

    def __enter__(self) -> _Span:
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = _profiler_range(self.name)
            self.range.__enter__()
        self.timer._opened(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        self.timer._closed(self.name, self.seconds)


@dataclass
class StageTimer:
    stages: dict[str, float] = field(default_factory=dict)   # summed seconds by span
    calls: dict[str, int] = field(default_factory=dict)      # spans closed, by name
    parents: dict[str, set] = field(default_factory=dict)    # names open around each ("" at the top)
    counters: dict[str, int] = field(default_factory=dict)
    verbose: bool = field(default_factory=lambda: bool(os.environ.get("MS_TPU_TRACE")))
    _open: list[str] = field(default_factory=list)

    def stage(self, name: str) -> _Span:
        """A span: ``with timer.stage(name) as span: ...``."""
        return _Span(self, name)

    def _opened(self, name: str) -> None:
        self.parents.setdefault(name, set()).add(self._open[-1] if self._open else "")
        self._open.append(name)

    def _closed(self, name: str, elapsed: float) -> None:
        self._open.pop()
        self.stages[name] = self.stages.get(name, 0.0) + elapsed
        self.calls[name] = self.calls.get(name, 0) + 1
        if self.verbose:
            print(f"[ms-tpu] {name}: {elapsed:.3f}s", file=sys.stderr)

    def count(self, name: str, value: int) -> None:
        self.counters[name] = value
        if self.verbose:
            print(f"[ms-tpu] {name} = {value}", file=sys.stderr)

    def totals(self) -> dict[str, float | int]:
        """Each span's summed seconds as ``<name>_s`` and its count as
        ``<name>_n``."""
        out: dict[str, float | int] = {}
        for name, seconds in self.stages.items():
            out[f"{name}_s"] = seconds
            out[f"{name}_n"] = self.calls[name]
        return out


@contextlib.contextmanager
def torch_profile(outdir: str | None, device):
    """Capture a ``torch.profiler`` trace around a block when ``outdir`` is
    set: CPU activity, and the card's too when ``device`` is one.  The
    Chrome trace goes to ``outdir/trace_<pid>_<ns>.json``."""
    if not outdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(outdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
