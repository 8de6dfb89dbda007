#!/usr/bin/env python3
"""Time a Myers kernel of two trees of the port on one batch, in turns.

    PYTHONPATH=. python3 scripts/torch_myers_ab.py --base DIR [--kernel {full,banded}]
        [--reps 20] [--out FILE]

Builds the refinement batch of ``chip_smoke.py`` phase 7 (the E. coli-scale
simulation, reads with 8 % noise, host mapping, every mapped region packed
as ``refine_mappings`` packs it), saves it, and runs ``myers_edit_distance``
(``--kernel full``, the default) or ``myers_banded`` at 8 window words
(``--kernel banded``, the wavefront engine's kernel at band 256) of the tree
``--base`` (an unpacked checkout, such as the parent commit) and of this
tree in turns, base, this, this, base, each in a process of its own
that builds its tree's kernels.  Each turn prints the median CUDA-event ms
of one call, the median of the wrapper's launch plan alone
(``schedule_problems``, null for a tree without one), the host wall of the
process's first call (the kernel library already loaded), and a hash of the
distances; the four hashes must agree.  Each turn
also gives the device time of every kernel its calls launch, per launch,
from ``torch.profiler`` (``device_ms``: the kernel alone, without the
wrapper's host work that the event window holds).  The
summary line holds the batch's bound (15 int32 ops per (column, word) step
at 64 ops per clock per SM and the card's maximum SM clock, or the bytes at
3.35 TB/s, whichever is larger; the banded kernel steps its 8 window words
over the columns of the problems inside the band).  Needs one NVIDIA GPU.
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
from muchsalsa_tpu_torch.ops.myers_torch import myers_banded, myers_edit_distance
args = tuple(x.cuda() for x in torch.load(sys.argv[1]))
reps = int(sys.argv[2])
banded = sys.argv[3] == "banded"
call = (lambda *a: myers_banded(*a, window_words=8)) if banded else myers_edit_distance
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
schedule = None if banded else getattr(myers_torch, "schedule_problems", None)
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
                  "sha256": hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()}))
"""


def refinement_batch(path: Path, banded: bool) -> tuple[int, int, int, float, int, float]:
    """The phase-7 batch, saved to ``path`` as CPU tensors; returns its
    shape (P, M, N), the wall of building it, the Myers ops the kernel
    needs on it and its bytes."""
    import time

    import numpy as np
    import torch

    from muchsalsa_tpu_torch.config import Config
    from muchsalsa_tpu_torch.pipeline.mapper_torch import MinimizerIndex, SequenceStore, map_all
    from muchsalsa_tpu_torch.testing.simulate import add_noise, simulate

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
    if banded:
        from muchsalsa_tpu_torch.ops.myers_torch import geometry

        klo, khi, _h = geometry(8)
        diff = n - m
        in_band = (diff - klo >= 32) & (khi - diff >= 32) & (m > 0) & (n > 0)
        ops = 15 * 8 * int(torch.where(in_band, n, 0).sum())
    else:
        ops = 15 * int(((m + 31) // 32 * n).sum())
    nbytes = q.numel() + t.numel() + 12 * q.shape[0]
    return q.shape[0], q.shape[1], t.shape[1], time.perf_counter() - t0, ops, nbytes


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=Path, help="the other tree (a checkout)")
    ap.add_argument("--kernel", choices=("full", "banded"), default="full")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None, help="also write the lines here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_myers_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout.splitlines()[0]
    name, power, clock_mhz = (f.strip() for f in smi.split(","))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lines = []

    def emit(**fields):
        lines.append(json.dumps(fields))
        print(lines[-1], flush=True)

    with tempfile.TemporaryDirectory(prefix="ms_myers_ab_") as td:
        batch = Path(td) / "batch.pt"
        P, M, N, build_s, ops, nbytes = refinement_batch(batch, args.kernel == "banded")
        ops_ms = ops / (64 * sms * float(clock_mhz) * 1e6) * 1e3
        bytes_ms = nbytes / 3.35e12 * 1e3
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
            emit(turn=turn, tree="base" if tree == args.base else "this", **row)
        emit(card=f"{name}, {power} W", kernel=args.kernel, sms=sms, clocks_max_sm_mhz=float(clock_mhz), P=P, M=M,
             N=N, batch_build_s=build_s, myers_ops=ops, bytes=nbytes,
             bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms
             else "bytes", identical=len(hashes) == 1)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0 if len(hashes) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
