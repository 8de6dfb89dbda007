#!/usr/bin/env python3
"""The scale rows of ``full`` through the PyTorch port: the twin of
``scripts/scale_run.py`` (the JAX package's), argument for argument.

    PYTHONPATH=. python3 scripts/torch_scale_run.py [genome_mb=12] [coverage=12] \\
        [out=build/torch_scale_run] [illu_cov=30] [--host] [--device-map] \\
        [--device {cuda,cpu}] [--chain-batches]

Writes the JAX script's inputs (``testing/scale.py::make_scale_inputs``:
a genome of ``genome_mb`` Mb, 9 kb long reads at ``coverage`` with 7 %
noise and junk tails on a fifth of them, 30x error-free Illumina pairs)
into ``out`` and runs the port's ``full`` on them into ``out/full_out``.
The positional arguments are read by place, as the JAX script reads them,
so flags come after them.  ``--device`` (default ``cuda``, which raises
without a card) is where the core's chaining and every device leg run;
``--host`` puts the k-mer, DBG, scrub and mapping legs on the host, and
``--device-map`` puts the map stages on the device (on already, unless
``--host``).  ``--chain-batches`` keeps a host copy of every packed batch
the core hands ``chain_dp`` and, after the run, times the kernel on each
(CUDA events and ``torch.profiler`` device time) beside its byte bound,
checked against ``chain_dp_reference``; it needs the card.

Prints the JAX script's ``[scale_run]`` lines, the card's name and power
limit as ``nvidia-smi`` gives them, then one JSON line: each stage's
``elapsed_s``, the contig statistics, the sha256 of the three inputs and
the assembly and whether each equals its row of ``SCALE_ROWS``, peak CUDA
memory, the device legs' counters, each map stage's overflow and tier-2
reads, the core's chaining counters and ``chain_dp`` launches.  Exits 1
where a recorded hash or statistic differs, or where JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
DEFAULT_OUT = REPO / "build" / "torch_scale_run"
DEVICES = ("cuda", "cpu")


def parse_args(argv: list[str]) -> dict:
    """``argv`` (``sys.argv``) read as ``scripts/scale_run.py`` reads it:
    ``genome_mb coverage out illu_cov`` by place, each optional, and the
    flags anywhere; a place that does not parse raises ValueError as it
    does there.  ``--device`` takes the next argument, ``cuda`` or
    ``cpu``."""
    genome_mb = float(argv[1]) if len(argv) > 1 else 12.0
    coverage = float(argv[2]) if len(argv) > 2 else 12.0
    out = Path(argv[3]) if len(argv) > 3 else DEFAULT_OUT
    illu_cov = float(argv[4]) if len(argv) > 4 else 30.0
    device = "cuda"
    if "--device" in argv:
        at = argv.index("--device") + 1
        device = argv[at] if at < len(argv) else ""
        if device not in DEVICES:
            raise ValueError(f"--device takes one of {DEVICES}, not {device!r}")
    return {"genome_mb": genome_mb, "coverage": coverage, "out": out, "illu_cov": illu_cov,
            "host": "--host" in argv, "device_map": "--device-map" in argv,
            "device": device, "chain_batches": "--chain-batches" in argv}


def chain_figures(batches: list, device: torch.device) -> list[dict]:
    """Each kept batch's problems and anchors, ``chain_dp`` against its plain
    version, its median CUDA-event ms, its ``torch.profiler`` device ms a
    call and its bound (``utils/roofline.py::dp_bound``)."""
    from muchsalsa_tpu_torch.ops.chain_scan import chain_dp, chain_dp_reference
    from muchsalsa_tpu_torch.utils.roofline import device_ms, dp_bound, median_ms

    rows = []
    for host, K, wiggle in batches:
        packed = [x.to(device) for x in host]
        sizes = host[2][1:] - host[2][:-1]
        s, b = chain_dp(*packed, K, wiggle)
        s_ref, b_ref = chain_dp_reference(*packed, K, wiggle)
        equal = torch.equal(s, s_ref) and torch.equal(b, b_ref)
        err = float((s - s_ref).abs().max()) if s.numel() else 0.0
        del s_ref, b_ref
        ms = median_ms(lambda: chain_dp(*packed, K, wiggle), reps=20)
        dev_ms = device_ms(lambda: chain_dp(*packed, K, wiggle), ("chain_dp",))
        bound_ms, bound_by = dp_bound(host[2], K)
        rows.append({"K": K, "B": int(sizes.numel()), "problems": int((sizes > 0).sum()),
                     "anchors": int(host[2][-1]), "equal": equal, "max_abs_err": err,
                     "ms": ms, "device_ms": dev_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "event_share": bound_ms / ms,
                     "device_share": bound_ms / dev_ms if dev_ms else None})
        del packed
    return rows


def reference_modules() -> list[str]:
    return sorted(m for m in sys.modules if m in ("jax", "muchsalsa_tpu")
                  or m.startswith(("jax.", "muchsalsa_tpu.")))


def main(argv: list[str] | None = None) -> int:
    args = parse_args(sys.argv if argv is None else argv)

    from muchsalsa_tpu_torch.device import resolve_device
    from muchsalsa_tpu_torch.testing.scale import run_scale_row

    dev = resolve_device(args["device"])
    on_card = dev.type == "cuda"
    if args["chain_batches"] and not on_card:
        raise ValueError("--chain-batches times chain_dp on the card: it needs --device cuda")
    card = None
    if on_card:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    # --device-map puts the map stages on the device, where they are unless --host
    batches = [] if args["chain_batches"] else None
    record = run_scale_row(args["out"], args["genome_mb"], args["coverage"], args["illu_cov"],
                           device=dev, host=args["host"], keep_batches=batches,
                           log=lambda line: print(line, flush=True))
    loaded = reference_modules()
    record.update(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  reference_loaded=loaded)
    if batches:
        record["chain_batches"] = chain_figures(batches, dev)
    if card is not None:
        print(card, flush=True)
    print(json.dumps(record, default=str), flush=True)
    ok = all(record["equal"].values()) and not loaded
    if batches:
        ok = ok and all(r["equal"] for r in record["chain_batches"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
