#!/usr/bin/env python3
"""Time the chaining DP of one or two trees of the port on the core's own batch.

    PYTHONPATH=. python3 scripts/torch_chain_ab.py [--base DIR] [--reps 20] [--out FILE]

Simulates the dataset of ``chip_smoke.py`` phase 4 (4.6 Mb genome, 15x,
9 kb reads, 1 kb unitigs, seed 20260819), runs this tree's
``assemble(device="cuda")`` on it once (its wall, chaining stage and peak
CUDA memory go on the first line) and keeps what the chaining phase had in
hand for its largest bucket: the gathered anchor fields, each anchor's row,
the problems' sizes and strand classes.  Then each turn, in a process of its
own that builds its tree's kernels, times one bucket of the chaining phase
on it, from the gathered fields to the scores and backpointers on the host:

- ``field_main_*``: the chaining phase's earlier per-field path (zeroed
  numpy tables scattered per field, ``state.batch_to_torch``'s 17 pageable
  copies, ``compat_init_batch`` and ``chain_scan``, results back);
- ``packed_main_*`` (a tree with ``chaining_torch.bucket_batch``): this
  tree's chaining phase (``bucket_batch``, the anchors alone, into pinned
  memory, three non-blocking copies, ``chain_dp``, results back), and
  ``packed_pageable_*`` the same with ``pin=False``;

each as the host wall of the process's first call (``*_first_ms``: the
pinned path's first call pays for its pinned allocation, as the core's one
bucket does), the median host wall of ``--reps`` calls after two warm-up
calls (``*_ms``), and the CUDA memory the path allocates beyond what was
live before it (``*_peak_bytes``).  Then, with CUDA events (median of
``--reps``), the device half's parts on the copied batch:

- ``copy_ms``: the per-field copies; ``compat_ms``: ``compat_init_batch``'s
  torch ops alone; ``scan_ms``: the ``chain_scan`` kernel alone on that
  compat matrix; ``compat_scan_ms``: the two together;
- with ``bucket_batch``, ``pack_copy_ms``: the packed batch's three
  non-blocking copies; ``chain_dp_ms``: the fused kernel alone;

and ``device_ms``: the device time of each chaining kernel alone, per
launch, from ``torch.profiler`` (the event windows above also hold the
wrappers' host work).

Every turn checks that its paths agree bit for bit and prints a hash of the
scores and backpointers; the hashes of all turns must agree.  With
``--base`` (an unpacked checkout of this tree or of one without
``bucket_batch``, such as an earlier commit) the turns run base, this,
this, base; without it, this tree twice.  The summary line holds the
batch's byte bound for ``chain_dp``: each anchor's 13 float64 fields and
flag byte and the B + 1 int32 offsets read, every slot's score (float64)
and backpointer (int32) written, at 3.35 TB/s.  Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_TURN = r"""
import hashlib, json, statistics, sys, time
import numpy as np
import torch
from muchsalsa_tpu_torch import kernels, state
from muchsalsa_tpu_torch.ops import chain_scan as cs
from muchsalsa_tpu_torch.ops import chaining_torch as ct

z = np.load(sys.argv[1])
reps = int(sys.argv[2])
wiggle, B, K = int(z["wiggle"]), int(z["B"]), int(z["K"])
src, sizes, cls_dir = z["src"], z["sizes"], z["cls_dir"]
total = len(src)
# each anchor's slot in the padded (B, K) tables
dest = (np.repeat(np.arange(len(sizes)), sizes) * K
        + np.arange(total) - np.repeat(np.cumsum(sizes) - sizes, sizes))
f = {k[2:]: z[k] for k in z.files if k.startswith("f_")}
dev = torch.device("cuda")
packed = hasattr(ct, "bucket_batch")
kernels.load()
# load each kernel's module before any timed call
c1 = torch.zeros((1, K, K), dtype=torch.uint8, device=dev)
i1 = torch.zeros((1, K), dtype=torch.float64, device=dev)
cs.chain_scan(c1, i1)
if packed:
    cs.chain_dp(torch.zeros((13, 0), dtype=torch.float64, device=dev),
                torch.zeros((0,), dtype=torch.uint8, device=dev),
                torch.zeros((2,), dtype=torch.int32, device=dev), K, wiggle)
torch.cuda.synchronize()

def field_arrays():
    # the chaining phase's earlier per-field bucket build, line for line
    arrs = {}
    for bf, gf in ct._FIELD_MAP.items():
        a = np.zeros(B * K, dtype=np.float64)
        if bf in ("v_rr", "w_rr"):
            a[:] = 1.0
        a[dest] = f[gf][src]
        arrs[bf] = a.reshape(B, K)
    for bf, gf in (("v_dir", "v_dir"), ("w_dir", "w_dir")):
        a = np.zeros(B * K, dtype=bool)
        a[dest] = f[gf][src]
        arrs[bf] = a.reshape(B, K)
    valid = np.zeros(B * K, dtype=bool)
    valid[dest] = True
    arrs["valid"] = valid.reshape(B, K)
    cls = np.zeros(B, dtype=bool)
    cls[:len(cls_dir)] = cls_dir
    arrs["cls_dir"] = cls
    return arrs

def field_main():
    arrs = field_arrays()
    s, b = cs.chain_scan(*ct.compat_init_batch(state.batch_to_torch(arrs, dev), wiggle))
    return s.cpu().numpy(), b.cpu().numpy()

def packed_main(pin=True):
    batch = ct.bucket_batch(f, src, sizes, cls_dir, B, pin=pin)
    s, b = cs.chain_dp(*(x.to(dev, non_blocking=True) for x in batch), K, wiggle)
    return s.cpu().numpy(), b.cpu().numpy()

def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out

def peak(fn):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - live

def median_wall_ms(fn):
    for _ in range(2):
        fn()
    return statistics.median(wall_ms(fn)[0] for _ in range(reps))

def event_ms(fn):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)

paths = {"field_main": field_main}
if packed:
    paths.update(packed_main=packed_main, packed_pageable=lambda: packed_main(pin=False))
row = {}
results = {}
# first calls, the pinned path first: its first pinned allocation in the process
for name in sorted(paths, key=lambda n: n != "packed_main"):
    row[name + "_first_ms"], results[name] = wall_ms(paths[name])
for name, fn in paths.items():
    row[name + "_ms"] = median_wall_ms(fn)
    row[name + "_peak_bytes"] = peak(fn)
s, b = results["field_main"]
for name, (s2, b2) in results.items():
    if not (np.array_equal(s, s2) and np.array_equal(b, b2)):
        raise SystemExit(f"{name} disagrees with the per-field path")

arrs = field_arrays()
batch = state.batch_to_torch(arrs, dev)
compat, init = ct.compat_init_batch(batch, wiggle)
row.update(copy_ms=event_ms(lambda: state.batch_to_torch(arrs, dev)),
           compat_ms=event_ms(lambda: ct.compat_init_batch(batch, wiggle)),
           scan_ms=event_ms(lambda: cs.chain_scan(compat, init)),
           compat_scan_ms=event_ms(lambda: cs.chain_scan(*ct.compat_init_batch(batch, wiggle))))
if packed:
    host = ct.bucket_batch(f, src, sizes, cls_dir, B, pin=True)
    on_card = [x.to(dev) for x in host]
    row.update(pack_copy_ms=event_ms(lambda: [x.to(dev, non_blocking=True) for x in host]),
               chain_dp_ms=event_ms(lambda: cs.chain_dp(*on_card, K, wiggle)))
# device time of each kernel, per launch (CUPTI), over five calls of each
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        cs.chain_scan(compat, init)
        if packed:
            cs.chain_dp(*on_card, K, wiggle)
    torch.cuda.synchronize()
averages = prof.key_averages()
col = "self_device_time_total" if hasattr(averages[0], "self_device_time_total") else "self_cuda_time_total"
row["device_ms"] = {e.key[:80]: getattr(e, col) / e.count / 1e3 for e in averages
                    if e.device_type == DeviceType.CUDA and getattr(e, col)}
row["sha256"] = hashlib.sha256(s.tobytes() + b.tobytes()).hexdigest()
print(json.dumps(row))
"""


def core_batch(path: Path) -> dict:
    """Run this tree's core on the phase-4 dataset, save what the chaining
    phase had in hand for its largest bucket to ``path`` (npz: the gathered
    fields as ``f_<name>``, ``src``, ``sizes``, ``cls_dir``, ``B``, ``K``,
    ``wiggle``) and return the run's numbers."""
    import numpy as np
    import torch

    from muchsalsa_tpu_torch.assemble.driver import assemble
    from muchsalsa_tpu_torch.ops import chaining_torch as ct
    from muchsalsa_tpu_torch.testing.simulate import simulate, write_simulation

    kept: dict = {"B": -1}
    real_bucket, real_dp = ct.bucket_batch, ct.chain_dp

    def bucket_hook(f, src, sizes, cls_dir, B, *, pin):
        if B > kept["B"]:
            names = (*ct._FIELD_MAP.values(), "v_dir", "w_dir")
            kept.update(src=src, sizes=sizes, cls_dir=cls_dir, B=B,
                        f={name: f[name] for name in names})
        return real_bucket(f, src, sizes, cls_dir, B, pin=pin)

    def dp_hook(fields, flags, offsets, K, wiggle):
        if offsets.shape[0] - 1 == kept["B"]:
            kept.update(K=K, wiggle=wiggle)
        return real_dp(fields, flags, offsets, K, wiggle)

    ct.bucket_batch, ct.chain_dp = bucket_hook, dp_hook
    with tempfile.TemporaryDirectory(prefix="ms_chain_ab_core_") as td:
        t0 = time.perf_counter()
        sim = simulate(np.random.default_rng(20260819), genome_length=4_600_000,
                       coverage=15.0, read_length=9_000, unitig_length=1_000, unitig_gap=300)
        paths = write_simulation(sim, Path(td) / "data")
        del sim
        simulate_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = assemble(paths["paf"], paths["unitigs"], paths["reads"], Path(td) / "out",
                     device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ct.bucket_batch, ct.chain_dp = real_bucket, real_dp
    if kept["B"] < 0:
        raise RuntimeError("the core sent no chaining batch to the card")
    np.savez(path, wiggle=np.int64(kept["wiggle"]), B=np.int64(kept["B"]),
             K=np.int64(kept["K"]), src=kept["src"], sizes=kept["sizes"],
             cls_dir=kept["cls_dir"], **{f"f_{k}": v for k, v in kept["f"].items()})
    g = {k: v[kept["src"]] for k, v in kept["f"].items()}
    # the share of the corrected ranges' four numerators that are 0 (the
    # kernel skips those divisions) and of the rRatios that are 1.0
    trims = np.stack([g["ov_start"] - g["v_is"], g["v_ie"] - g["ov_end"],
                      g["ov_start"] - g["w_is"], g["w_ie"] - g["ov_end"]])
    return {"simulate_s": simulate_s, "core_wall_s": wall,
            "zero_trim_share": float((trims == 0).mean()),
            "unit_rratio_share": float((np.stack([g["v_rr"], g["w_rr"]]) == 1.0).mean()),
            "chaining_s": r["timer"].stages.get("chaining"),
            "core_cuda_peak_bytes": r["memory"]["device_peak_bytes_allocated"],
            "B": kept["B"], "K": kept["K"], "problems": len(kept["sizes"]),
            "anchors": len(kept["src"])}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, default=None, help="the other tree (a checkout)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None, help="also write the lines here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_chain_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0].strip()
    lines = []

    def emit(**fields):
        lines.append(json.dumps(fields))
        print(lines[-1], flush=True)

    trees = (args.base, REPO, REPO, args.base) if args.base else (REPO, REPO)
    with tempfile.TemporaryDirectory(prefix="ms_chain_ab_") as td:
        batch = Path(td) / "batch.npz"
        info = core_batch(batch)
        emit(card=card, **info)
        hashes = set()
        for turn, tree in enumerate(trees):
            env = dict(os.environ, PYTHONPATH=str(tree.resolve()))
            proc = subprocess.run([sys.executable, "-c", _TURN, str(batch), str(args.reps)],
                                  capture_output=True, text=True, env=env,
                                  cwd=tree.resolve(), timeout=900)
            if proc.returncode != 0:
                print(proc.stderr, file=sys.stderr)
                return proc.returncode or 1
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            hashes.add(row["sha256"])
            emit(turn=turn, tree="base" if tree == args.base else "this", **row)
    from muchsalsa_tpu_torch.utils.roofline import HBM_BYTES_PER_S, dp_bytes

    B, K = info["B"], info["K"]
    nbytes = dp_bytes(info["anchors"], B, K)
    emit(card=card, B=B, K=K, anchors=info["anchors"], bytes=nbytes,
         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", identical=len(hashes) == 1)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0 if len(hashes) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
