"""One run of a cell: set-up, the measured window of map-stage jobs, the
comparison with the plain reference, and the result's line.

A job is one map stage as ``pipeline/full.py::map_stage`` runs it once its
index is built: ``map_all(index, reads, cfg.mapper, unitigs=unitigs,
device=True, torch_device=..., stats=...)``, ``reads`` a fresh
``SequenceStore`` of the cell's reads each time, built outside the job's
clock.  The window runs whole jobs until its seconds have passed; every job
maps the same reads against the same index, and every PAF line of every job
is held to the reference's.

Everything that belongs to one cell is data found by name: the cell and
its metrics in ``BENCHMARK.json``, its configuration in the file that names,
its traffic mix in ``traffic/<name>.json`` and each metric's reader in
``metrics/<name>.py``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import reference, sim
from portbench.reference.mapper import Params

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "muchsalsa_tpu")
THREADS = 4          # torch's host threads: half of a one-card machine's 8 cores
WARM_REFINE_READS = 512   # reads whose mappings warm refinement up in set-up
REFINE_SAMPLE = 4096      # mappings a refined job's check holds to the exact edit distance
NAME_CHARS = 100   # a device operation's name in the breakdown, cut to this length


@dataclass
class Job:
    reads: int
    wall_s: float
    stats: dict            # map_all's stats: numbers only
    map_stats: dict        # DEVICE_MAP_STATS after the job
    lines: list[str]


@dataclass
class Trace:
    busy_s: float
    window_s: float
    device_ops: dict[str, float]          # device seconds by kernel or copy name
    idle_gaps: list[tuple[str, float]]    # the longest gaps, each by the span around it


@dataclass
class Run:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: str
    setup_s: float = 0.0
    peak_bytes: int = 0
    jobs: list[Job] = field(default_factory=list)
    trace: Trace | None = None
    sm_count: int = 0
    inputs: sim.Inputs | None = None
    phases: dict[str, float] = field(default_factory=dict)   # seconds of set-up's parts
    memory: list[tuple[int, int]] = field(default_factory=list)  # (allocated, peak) after each job
    host_cpu: tuple[str, float] = ("", 0.0)    # host_state() as the window opens


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_parts(bench: dict, workload: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    return cell, config, load_traffic(cell["traffic"])


def load_traffic(name: str) -> dict:
    path = HERE / "traffic" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no traffic file {path}")
    return json.loads(path.read_text())


def metric_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end ones, or
    with ``trace`` its per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def mapper_params(traffic: dict):
    """The program's ``MapperConfig`` and the reference's ``Params`` for a
    traffic mix: ``Config()``'s mapper with the mix's ``mapper`` entries."""
    from muchsalsa_tpu_torch.config import MapperConfig

    mc = dataclasses.replace(MapperConfig(), **traffic.get("mapper", {}))
    params = Params(k=mc.k, w=mc.w, max_occ=mc.max_occ, bandwidth=mc.bandwidth,
                    min_anchor_count=mc.min_anchor_count, min_chain_score=mc.min_chain_score)
    return mc, params


def store_of(records):
    from muchsalsa_tpu_torch.io.fasta import SequenceStore

    store = SequenceStore()
    for name, seq in records:
        store.add(name, seq)
    return store


def run_window(run: Run, seconds: float, trace: bool, t_start: float) -> None:
    """Set up, run the window of jobs and read the card's peak into ``run``."""
    from muchsalsa_tpu_torch.pipeline import mapper_torch

    dev = torch.device(run.device)
    cuda = dev.type == "cuda"
    clock = t_start

    def phase(name):
        nonlocal clock
        now = time.perf_counter()
        run.phases[name] = now - clock
        clock = now

    phase("process")                     # interpreter, imports, CUDA context
    inputs = sim.make_inputs(run.config, run.seed, dev)
    phase("inputs")
    mc, _params = mapper_params(run.traffic)
    unitigs = store_of(inputs.unitig_records())
    records = inputs.read_records()
    phase("stores")
    index = mapper_torch.MinimizerIndex.build(unitigs, mc)
    phase("index")

    def job(store, stats, cfg=mc):
        return mapper_torch.map_all(index, store, cfg, unitig_names=unitigs.registry.name,
                                    read_names=store.registry.name, unitigs=unitigs,
                                    device=True, torch_device=run.device, stats=stats)

    if cuda:
        torch.cuda.empty_cache()         # the inputs' temporaries
    # one whole job's mapping warms every read length's shapes and fills the
    # allocator's cache, so the window's first job finds what its last one
    # does; refinement, which builds no shape of its own, warms on a slice
    job(store_of(records), {}, dataclasses.replace(mc, refine=False))
    if mc.refine:
        job(store_of(records[:WARM_REFINE_READS]), {})
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        run.memory.append((torch.cuda.memory_allocated(dev), 0))
    phase("warm")
    run.setup_s = time.perf_counter() - t_start
    run.inputs = inputs

    def spans(name):
        """A span of the benchmark's own: a ``torch.profiler`` range when traced."""
        return torch.profiler.record_function(name) if trace else nullcontext()

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if trace else None
    if prof is not None:
        prof.start()
    run.host_cpu = host_state()
    t_window = time.perf_counter()
    with spans("window"):
        while time.perf_counter() - t_window < seconds:
            with spans("job.store"):
                store = store_of(records)
            stats: dict = {}
            t0 = time.perf_counter()
            with spans("job.map_all"):
                lines = job(store, stats)
            wall = time.perf_counter() - t0
            run.jobs.append(Job(len(records), wall,
                                {k: v for k, v in stats.items() if isinstance(v, (int, float))},
                                dict(mapper_torch.DEVICE_MAP_STATS), lines))
            del store, stats
            if cuda:
                run.memory.append((torch.cuda.memory_allocated(dev),
                                   torch.cuda.max_memory_allocated(dev)))
    if cuda:
        torch.cuda.synchronize(dev)
    if prof is not None:
        prof.stop()
        run.trace = read_trace(prof)
    if cuda:
        run.peak_bytes = int(torch.cuda.max_memory_allocated(dev))
        run.sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    del job, index, unitigs, records
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def host_state() -> tuple[str, float]:
    """The host CPU's model and its cores' mean clock in MHz, as
    ``/proc/cpuinfo`` gives them ("", 0 where it does not)."""
    model, mhz = "", []
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, _, value = line.partition(":")
                if key.strip() == "model name":
                    model = value.strip()
                elif key.strip() == "cpu MHz":
                    mhz.append(float(value))
    except (OSError, ValueError):
        pass
    return model, round(sum(mhz) / len(mhz), 1) if mhz else 0.0


def short_name(name: str) -> str:
    """A device operation's name without its namespaces, cut to
    ``NAME_CHARS``."""
    for noise in ("void ", "at::native::", "at_cuda_detail::", "(anonymous namespace)::",
                  "std::"):
        name = name.replace(noise, "")
    return name[:NAME_CHARS]


def read_trace(prof) -> Trace:
    """Busy seconds, device time by name and the longest idle gaps of the
    traced window, from the profiler's events."""
    try:
        events = prof.profiler.kineto_results.events()
        rows = [(e.name(), str(e.device_type()), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in events]
    except AttributeError:
        rows = [(e.key, str(e.device_type), int(e.time_range.start * 1000),
                 int(e.time_range.end * 1000)) for e in prof.events()]
    window = [(s, e) for n, d, s, e in rows if n == "window" and "CPU" in d]
    spans = [(s, e, n) for n, d, s, e in rows if n.startswith("job.") and "CPU" in d]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window[0]
    # the profiler mirrors each of our spans on the device's timeline as an
    # annotation over the kernels it launched: that is no device work
    ours = {"window"} | {n for _s, _e, n in spans}
    device = [(max(s, w0), min(e, w1), short_name(n)) for n, d, s, e in rows
              if "CUDA" in d and n not in ours and e > w0 and s < w1]
    ops: dict[str, float] = {}
    for s, e, n in device:
        ops[n] = ops.get(n, 0.0) + (e - s) / 1e9
    busy = 0
    gaps = []
    cursor = w0
    for s, e, _n in sorted(device):
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if w1 > cursor:
        gaps.append((cursor, w1))
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        label = next((n for s, e, n in spans if s <= mid <= e), "window")
        labelled.append((label, (b - a) / 1e9))
    return Trace(busy / 1e9, (w1 - w0) / 1e9, ops, labelled)


def _differs(line: str, ref: str) -> bool:
    """Whether a job's PAF line differs from the reference's; a reference
    line whose matches read ``*`` leaves that field out."""
    if line == ref:
        return False
    a, b = line.split("\t"), ref.split("\t")
    return not (b[9] == "*" and len(a) == len(b) and a[:9] == b[:9] and a[10:] == b[10:])


def check(run: Run, ref_lines: list[str]) -> tuple[int, dict]:
    """Jobs whose lines differ from the reference's, and the numbers
    compared, each with its limit."""
    wrong = [sum(map(_differs, job.lines, ref_lines)) + abs(len(job.lines) - len(ref_lines))
             for job in run.jobs]
    failed = sum(w > 0 for w in wrong)
    checks = {"lines_wrong": {"value": max(wrong, default=0), "limit": 0},
              "jobs_wrong": {"value": failed, "limit": 0}}
    return failed, checks


def reference_lines(run: Run, params: Params | None = None) -> list[str]:
    """The reference's PAF lines for the run's inputs, on the run's device;
    in a refined job the matches of ``REFINE_SAMPLE`` mappings drawn from
    the seed, the others' ``*``."""
    mc, default = mapper_params(run.traffic)

    def sample(n):
        rng = np.random.default_rng([run.seed % (1 << 63), 2])
        return rng.choice(n, min(n, REFINE_SAMPLE), replace=False)

    return reference.paf(run.inputs, params or default, mc.refine, run.device,
                         lambda u: f"unitig_{u}", lambda r: f"read_{r}", sample)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def result(run: Run, bench: dict, trace: bool, failed: int, checks: dict, device: dict) -> dict:
    """The result's line: the cell's metrics that their readers find."""
    metrics = {}
    for m in cell_metrics(bench, run.cell["name"], trace):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(run.jobs) and all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(run.jobs), "failed": failed, "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        top = sorted(run.trace.device_ops.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[n, s] for n, s in top],
                            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps]}
    out["checks"] = checks
    return out
