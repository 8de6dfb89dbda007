"""Stage timers + lightweight structured logging.

TPU equivalent of the reference's TRACE macro / wall-clock prints
(``include/ms/Debug.h:28-32``, ``pipeline/pipeline.sh:110``): per-stage
host timers that can be dumped as JSON, plus optional ``torch.profiler``
trace capture around a stage.

The port's copy of ``StageTimer`` from ``muchsalsa_tpu/utils/timing.py``
(:19-45) and the host half of its ``memory_stats`` (:48-58); the device
half stays behind (the port's driver reads the card's peak with
``torch.cuda.max_memory_allocated``), and ``torch_profile`` takes the place
of ``jax_profile`` (:71-83).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field


@dataclass
class StageTimer:
    stages: dict[str, float] = field(default_factory=dict)
    counters: dict[str, int] = field(default_factory=dict)
    verbose: bool = field(default_factory=lambda: bool(os.environ.get("MS_TPU_TRACE")))

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.stages[name] = self.stages.get(name, 0.0) + elapsed
            if self.verbose:
                print(f"[ms-tpu] {name}: {elapsed:.3f}s", file=sys.stderr)

    def count(self, name: str, value: int) -> None:
        self.counters[name] = value
        if self.verbose:
            print(f"[ms-tpu] {name} = {value}", file=sys.stderr)

    def dump(self) -> str:
        return json.dumps(
            {"stages": self.stages, "counters": self.counters, "memory": memory_stats()},
            indent=2,
        )


def memory_stats() -> dict:
    """Peak host RSS, the TrackingAllocator equivalent
    (reference ``src/TrackingAllocator.cpp``, printed under
    TRACK_MEMORY_USAGE at ``main.cpp:317-319``)."""
    out: dict = {}
    try:
        import resource

        out["host_peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        pass
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
