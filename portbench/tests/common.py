"""Tiny cells for the CPU tests: the real configurations and mixes, with
the genome and the read set cut to a size a test run holds."""

from portbench import harness

TINY = dict(genome_length=60_000, job_reads=60, read_length=3_000)


def tiny_run(workload: str, seed: int = 2**31 + 17, **sizes) -> harness.Run:
    cell, config, traffic = harness.cell_parts(harness.load_benchmark(), workload)
    return harness.Run(cell, dict(config, **(sizes or TINY)), traffic, seed, "cpu")
