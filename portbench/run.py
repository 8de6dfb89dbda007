"""The benchmark of the PyTorch and CUDA port's map stage on one card.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout.  It makes the cell's genome, unitigs and
reads from the seed on the card, builds the index and warms every read
length up (set-up), then maps the same reads through
``muchsalsa_tpu_torch.pipeline.mapper_torch.map_all`` job after job for
``--seconds`` (the window), holds every job's PAF lines to the plain
reference under ``portbench/reference/``, and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones, read from a
``torch.profiler`` trace of the window), ``device``, ``breakdown`` with
``--trace 1``, and ``checks``: each number compared with its limit, which
are also the last lines on standard error.

It exits 1 and prints no result where no card is present or fewer than the
cell asks for, and where the process holds JAX or the JAX package when the
result is ready to print.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402

from portbench.harness import ROOT  # noqa: E402

CACHE = ROOT / "build" / "portbench"


def _caches() -> None:
    """Every build and kernel cache in a fixed folder of the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def _fail(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()

    import torch

    from portbench import harness

    torch.set_num_threads(harness.THREADS)
    bench = harness.load_benchmark()
    cell, config, traffic = harness.cell_parts(bench, args.workload)
    if not torch.cuda.is_available():
        _fail("no CUDA card: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < cell["chips"]:
        _fail(f"the cell asks for {cell['chips']} cards, {torch.cuda.device_count()} present")
    try:
        import muchsalsa_tpu_torch  # noqa: F401
    except ImportError as exc:
        _fail(f"the program under test is not in this checkout: {exc}")

    run = harness.Run(cell, config, traffic, args.seed, "cuda")
    harness.run_window(run, args.seconds, bool(args.trace), T_START)
    finish(run, bench, bool(args.trace))


def finish(run, bench: dict, trace: bool) -> None:
    """Hold the window's jobs to the reference, read the metrics and print
    the result's line; exit 1 with no line where the process holds JAX or
    the JAX package by then, the reference's and the readers' imports
    included."""
    import torch

    from portbench import harness
    from portbench.roofline import smi

    t_ref = time.perf_counter()
    failed, checks = harness.check(run, harness.reference_lines(run))
    print(f"portbench: memory (allocated, peak) {run.memory}; maps "
          f"{[(j.map_stats.get('tier2_reads'), j.map_stats.get('overflow_reads'), j.map_stats.get('dense_repulls')) for j in run.jobs[:2]]}; "
          f"threads {torch.get_num_threads()} of {os.cpu_count()} cores", file=sys.stderr)
    print(f"portbench: set-up {run.phases}, jobs {[round(j.wall_s, 3) for j in run.jobs]}, "
          f"reference {time.perf_counter() - t_ref:.3f} s, host peak RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} KiB; host CPU {run.host_cpu}",
          file=sys.stderr)

    power = smi("power.limit") if run.device == "cuda" else None
    kind = torch.cuda.get_device_name() if run.device == "cuda" else run.device
    device = {"platform": "gpu", "kind": kind, "count": run.cell["chips"],
              "memory_peak_bytes": run.peak_bytes,
              "power_limit_w": float(power) if power else None}
    out = harness.result(run, bench, trace, failed, checks, device)
    found = harness.forbidden_modules()
    if found:
        _fail(f"modules of JAX or the JAX package loaded: {found}")
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
