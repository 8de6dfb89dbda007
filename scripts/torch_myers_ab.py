#!/usr/bin/env python3
"""Time an edit-distance kernel of two trees of the port on one batch, in turns.

    PYTHONPATH=. python3 scripts/torch_myers_ab.py --base DIR
        [--kernel {full,banded,wavefront}] [--reps 20] [--out FILE]

Builds the refinement batch of ``chip_smoke.py`` phase 7 (the E. coli-scale
simulation, reads with 8 % noise, host mapping, every mapped region packed
as ``refine_mappings`` packs it), saves it, and runs ``myers_edit_distance``
(``--kernel full``, the default), ``myers_banded`` at 8 window words
(``--kernel banded``, the wavefront engine's Myers kernel at band 256) or
``banded_edit_distance`` at band 256 (``--kernel wavefront``, the banded
Levenshtein wavefront) of the tree ``--base`` (an unpacked checkout, such
as the parent commit) and of this tree in turns, base, this, this, base,
each in a process of its own that builds its tree's kernels.  Each turn
prints the median CUDA-event ms of one call, the median of the wrapper's
launch plan alone (``schedule_problems``, null for a tree or kernel without
one), the host wall of the process's first call (the kernel library
already loaded), and a hash of the results; the four hashes must agree.
Each turn also gives the device time of every kernel its calls launch, per
launch, from ``torch.profiler`` (``device_ms``: the kernel alone, without
the wrapper's host work that the event window holds).  With ``--kernel
wavefront`` each turn also counts, in its library's SASS (``cuobjdump
-sass``), the instructions of every row loop of the band-256 kernel, per
band cell, its loads, predicated loads and selects.

The summary line holds the batch's bound (``utils/roofline.py::align_work``
and ``bound``): the int32 ops at 64 ops per clock per SM and the card's
maximum SM clock, or the bytes at 3.35 TB/s, whichever is larger.  A Myers
(column, word) step is 15 ops (the banded kernel steps its 8 window words
over the columns of the problems inside the band); a wavefront band cell is
3 issue slots (the cost's compare, then two DPX add-mins, which do the
recurrence's other 4 ops), and the line also gives the cells and the share
of rows that read their target window with no bounds test.  Needs one
NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_TURN = r"""
import hashlib, json, statistics, sys, time
import torch
from muchsalsa_tpu_torch import kernels
from muchsalsa_tpu_torch.ops import myers_torch
from muchsalsa_tpu_torch.ops.align_torch import banded_edit_distance
from muchsalsa_tpu_torch.ops.myers_torch import myers_banded, myers_edit_distance
args = tuple(x.cuda() for x in torch.load(sys.argv[1]))
reps = int(sys.argv[2])
which = sys.argv[3]
call = {"full": myers_edit_distance,
        "banded": lambda *a: myers_banded(*a, window_words=8),
        "wavefront": lambda *a: banded_edit_distance(*a, band=256)}[which]
kernels.load()
torch.cuda.synchronize()
t0 = time.perf_counter()
out = call(*args)
torch.cuda.synchronize()
first_ms = (time.perf_counter() - t0) * 1e3
for _ in range(2):
    call(*args)
torch.cuda.synchronize()
def event_ms(fn):
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times
times = event_ms(lambda: call(*args))
# the exact wrapper's launch plan alone (sort, counts, the host table), where the tree has one
schedule = getattr(myers_torch, "schedule_problems", None) if which == "full" else None
schedule_ms = (statistics.median(event_ms(lambda: schedule(args[1], args[3], args[2].shape[1])))
               if schedule else None)
# device time of each kernel a call launches (CUPTI), per call
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        call(*args)
    torch.cuda.synchronize()
averages = prof.key_averages()
col = "self_device_time_total" if hasattr(averages[0], "self_device_time_total") else "self_cuda_time_total"
device_ms = {e.key[:80]: getattr(e, col) / e.count / 1e3 for e in averages
             if e.device_type == DeviceType.CUDA and getattr(e, col)}
print(json.dumps({"ms": statistics.median(times), "device_ms": device_ms,
                  "min_ms": min(times), "max_ms": max(times), "schedule_ms": schedule_ms, "first_call_ms": first_ms,
                  "sha256": hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest(),
                  "library": str(kernels.library_path())}))
"""


def refinement_batch(path: Path, kernel: str) -> dict:
    """The phase-7 batch, saved to ``path`` as CPU tensors; returns its
    shape (P, M, N), the wall of building it, its bytes, and the int32 ops
    ``kernel`` needs on it (for the wavefront also its band cells, the
    earlier 10-op count and its interior rows)."""
    import time

    import numpy as np
    import torch

    from muchsalsa_tpu_torch.config import Config
    from muchsalsa_tpu_torch.pipeline.mapper_torch import MinimizerIndex, SequenceStore, map_all
    from muchsalsa_tpu_torch.testing.simulate import add_noise, simulate
    from muchsalsa_tpu_torch.utils.roofline import align_work

    t0 = time.perf_counter()
    sim = simulate(np.random.default_rng(20260819), genome_length=4_600_000, coverage=15.0,
                   read_length=9_000, unitig_length=1_000, unitig_gap=300)
    unitigs, reads = SequenceStore(), SequenceStore()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    noise_rng = np.random.default_rng(1)
    for name, seq in sim.read_records():
        reads.add(name, add_noise(noise_rng, seq, 0.08))
    cfg = dataclasses.replace(Config().mapper, refine=True, refine_band=256)
    stats: dict = {}
    map_all(MinimizerIndex.build(unitigs, cfg), reads, cfg, unitigs=unitigs, device=False,
            torch_device="cuda", stats=stats)
    packed = tuple(x.cpu() for x in stats["packed"])
    torch.save(packed, path)
    q, ql, t, tl = packed
    m, n = ql.long(), tl.long()
    P, M, N = q.shape[0], q.shape[1], t.shape[1]
    name, kw = {"full": ("myers_full", {}), "banded": ("myers_banded", {"window_words": 8}),
                "wavefront": ("banded_wavefront", {"band": 256})}[kernel]
    nbytes, ops = align_work(name, packed, kw)
    out = {"P": P, "M": M, "N": N, "bytes": nbytes, "ops": ops}
    if kernel == "wavefront":
        B = 256
        diff = n - m
        ok = (diff.abs() < B) & (m > 0) & (n > 0)
        klo = torch.minimum(diff, torch.zeros_like(diff)) - torch.div(
            B - 1 - diff.abs(), 2, rounding_mode="floor")
        # the kernel's edge rows: 1..e1 start left of column 0, rows past e2 run past N
        e1 = torch.minimum(m, -klo)
        e2 = torch.maximum(e1, torch.minimum(m, N - klo - B + 1))
        rows = int(torch.where(ok, m, 0).sum())
        out.update(cells=B * rows, rows=rows,
                   interior_rows=int(torch.where(ok, e2 - e1, 0).sum()))
    out["batch_build_s"] = time.perf_counter() - t0
    return out


def sass_loops(library: str, C: int = 8) -> list[dict]:
    """Every loop of the wavefront kernel's C instantiation in ``library``'s
    SASS that sweeps rows (one SHFL.DOWN a row): its instructions per band
    cell, and its loads, predicated loads and selects."""
    import re
    from collections import Counter

    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    tool = str(cuobjdump) if cuobjdump.is_file() else "cuobjdump"
    sass = subprocess.run([tool, "-sass", library], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    body = None
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        if "wavefront_kernel" in name and f"ILi{C}E" in name:
            body = chunk
    if body is None:
        raise LookupError(f"no wavefront_kernel<{C}> in {library}")
    ins = []  # (address, predicate, opcode, branch target)
    for line in body.splitlines():
        hit = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if hit:
            target = re.search(r"0x([0-9a-f]+)", hit.group(4)) if hit.group(3).startswith(
                "BRA") else None
            ins.append((int(hit.group(1), 16), bool(hit.group(2)), hit.group(3),
                        int(target.group(1), 16) if target else None))
    spans = [(target, addr) for addr, _pred, op, target in ins
             if op.startswith("BRA") and target is not None and target < addr]
    loops = []
    for target, addr in spans:
        # innermost loops only: an enclosing span (the chunk loop, a divergent
        # fallback jumping back) holds another loop's branch
        if any(target <= t and a <= addr and (t, a) != (target, addr) for t, a in spans):
            continue
        inner = [x for x in ins if target <= x[0] <= addr and x[2] != "NOP"]
        rows = sum(x[2].startswith("SHFL.DOWN") for x in inner)
        if not rows:
            continue
        loads = [x for x in inner if x[2].startswith(("LDG", "LD.", "LDS"))]
        loops.append({
            "instructions": len(inner), "rows": rows, "per_cell": len(inner) / (rows * C),
            "loads": len(loads), "predicated_loads": sum(x[1] for x in loads),
            "sel": sum(x[2].startswith(("SEL", "FSEL")) for x in inner),
            "isetp": sum(x[2].startswith("ISETP") for x in inner),
            "dpx": sum(x[2].startswith(("VIADDMNMX", "VIMNMX")) for x in inner),
            "predicated": sum(x[1] for x in inner),
            "opcodes": dict(Counter(x[2].split(".")[0] for x in inner).most_common())})
    return loops


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=Path, help="the other tree (a checkout)")
    ap.add_argument("--kernel", choices=("full", "banded", "wavefront"), default="full")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None, help="also write the lines here")
    args = ap.parse_args(argv)

    import torch

    from muchsalsa_tpu_torch.utils.roofline import bound, card_int32_rate

    if not torch.cuda.is_available():
        print("torch_myers_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    name, power = (f.strip() for f in smi.split(","))
    sms, clock_mhz, ops_per_s = card_int32_rate()
    lines = []

    def emit(**fields):
        lines.append(json.dumps(fields))
        print(lines[-1], flush=True)

    with tempfile.TemporaryDirectory(prefix="ms_myers_ab_") as td:
        batch = Path(td) / "batch.pt"
        info = refinement_batch(batch, args.kernel)
        bound_ms, bound_by = bound(info["bytes"], info["ops"], ops_per_s)
        hashes = set()
        for turn, tree in enumerate((args.base, REPO, REPO, args.base)):
            env = dict(os.environ, PYTHONPATH=str(tree.resolve()))
            proc = subprocess.run([sys.executable, "-c", _TURN, str(batch), str(args.reps),
                                   args.kernel],
                                  capture_output=True, text=True, env=env,
                                  cwd=tree.resolve(), timeout=900)
            if proc.returncode != 0:
                print(proc.stderr, file=sys.stderr)
                return proc.returncode
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            hashes.add(row["sha256"])
            if args.kernel == "wavefront":
                row["sass_loops"] = sass_loops(row["library"])
            emit(turn=turn, tree="base" if tree == args.base else "this", **row)
        extra = {}
        if args.kernel == "wavefront":
            extra = {"interior_row_share": info["interior_rows"] / info["rows"]}
        emit(card=f"{name}, {power} W", kernel=args.kernel, sms=sms,
             clocks_max_sm_mhz=clock_mhz, **info, bound_ms=bound_ms, bound_by=bound_by,
             **extra, identical=len(hashes) == 1)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0 if len(hashes) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
