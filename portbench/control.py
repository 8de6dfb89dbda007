"""The control of ``correct``: the plain reference put in the program's
place with one guarantee broken, which the comparison has to fail.

    python3 -m portbench.control --workload NAME --seeds A,B,C

For each seed it makes the cell's inputs as a run does, computes the
reference's PAF lines and the control's (the reference with its index keyed
on the top ``KEY_BITS`` bits of the 32-bit minimizer hash: the configuration
states 32), and holds the control's lines to the reference's with the
comparison the runs use.  It prints one JSON line a seed with the numbers
compared, and exits 1 where the control passed on any seed.  The benchmark's
own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import harness, sim

KEY_BITS = 24   # the precision below the configuration's 32-bit hash


def control_checks(run: harness.Run) -> dict:
    """The run's reference and control lines compared as a run compares a
    job's; ``run`` needs its cell, configuration, traffic, seed and device."""
    run.inputs = sim.make_inputs(run.config, run.seed, torch.device(run.device))
    ref = harness.reference_lines(run)
    _mc, params = harness.mapper_params(run.traffic)
    params.key_bits = KEY_BITS
    run.jobs = [harness.Job(run.inputs.n_reads, 0.0, {}, {}, harness.reference_lines(run, params))]
    _failed, checks = harness.check(run, ref)
    return checks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell, config, traffic = harness.cell_parts(harness.load_benchmark(), args.workload)
    passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.Run(cell, config, traffic, seed, "cuda")
        checks = control_checks(run)
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        passed += [seed] if correct else []
        print(json.dumps({"workload": args.workload, "seed": seed, "key_bits": KEY_BITS,
                          "control_correct": correct, "checks": checks,
                          "seconds": time.perf_counter() - t0}), flush=True)
    if passed:
        print(f"the control passed the comparison on seeds {passed}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
