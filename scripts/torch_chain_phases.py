#!/usr/bin/env python3
"""Time the fused chaining kernel's parts apart on the core's own batch.

    PYTHONPATH=. python3 scripts/torch_chain_phases.py [--out FILE]

Runs this tree's core on the dataset of ``chip_smoke.py`` phase 4 (as
``scripts/torch_chain_ab.py`` does) and packs its largest chaining bucket
(K = 8) as the chaining phase packs it.  Builds ``torch_chain_phases.cu``
(the kernel source with variants that leave parts of the work out, listed
there) with the kernels' own nvcc flags, checks that the full variant gives
``chain_dp``'s scores and backpointers, and prints one line: the device ms
of one launch of each variant (CUDA events around 20 back-to-back launches,
median of 7), ``chain_dp`` through its wrapper the same way (its host work
between launches included), and a
device-to-device copy of the packed fields for the card's memory rate.
Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
VARIANTS = ("full", "no_pairs", "no_scan", "loads", "corrected", "full_no_div")


def per_launch_ms(fn, n: int = 20, reps: int = 7) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / n)
    return sorted(out)[reps // 2]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None, help="also write the line here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_chain_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import torch_chain_ab

    from muchsalsa_tpu_torch import kernels
    from muchsalsa_tpu_torch.ops import chain_scan as cs
    from muchsalsa_tpu_torch.ops import chaining_torch as ct

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0].strip()
    with tempfile.TemporaryDirectory(prefix="ms_chain_phases_") as td:
        torch_chain_ab.core_batch(Path(td) / "batch.npz")
        z = dict(np.load(Path(td) / "batch.npz"))
        so = Path(td) / "chain_phases.so"
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so),
                        str(HERE / "torch_chain_phases.cu")], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
    wiggle, B, K = int(z["wiggle"]), int(z["B"]), int(z["K"])
    if K != 8:
        raise SystemExit(f"the variants are built for K = 8, the core's largest bucket has {K}")
    f = {k[2:]: v for k, v in z.items() if k.startswith("f_")}
    packed = [x.cuda() for x in ct.bucket_batch(f, z["src"], z["sizes"], z["cls_dir"], B,
                                                pin=False)]
    N = packed[0].shape[1]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ms_chain_phase.argtypes = [ci, vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_double, vp]
    scores = torch.empty((B, K), dtype=torch.float64, device="cuda")
    bps = torch.empty((B, K), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(variant: int) -> None:
        code = lib.ms_chain_phase(variant, *(x.data_ptr() for x in packed), scores.data_ptr(),
                                  bps.data_ptr(), B, K, N, float(wiggle), stream)
        if code:
            raise RuntimeError(f"variant {variant}: CUDA error {code}")

    want = cs.chain_dp(*packed, K, wiggle)
    launch(0)
    torch.cuda.synchronize()
    if not (torch.equal(scores, want[0]) and torch.equal(bps, want[1])):
        raise SystemExit("the full variant disagrees with chain_dp")
    row = {"card": card, "B": B, "K": K, "anchors": N,
           "chain_dp_call_ms": per_launch_ms(lambda: cs.chain_dp(*packed, K, wiggle))}
    for i, name in enumerate(VARIANTS):
        row[f"{name}_ms"] = per_launch_ms(lambda: launch(i))
    row["copy_fields_ms"] = per_launch_ms(lambda: packed[0].clone())
    row["copy_fields_bytes"] = 2 * packed[0].numel() * 8
    line = json.dumps(row)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
