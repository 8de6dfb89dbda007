"""The kernel benchmark of the JAX package (``bench.py`` at the repo root) on the port.

    python -m muchsalsa_tpu_torch.bench [--device {cuda,cpu}] [--tiny]

Measures each of the JAX bench's figures at its fixed shapes, on inputs made
by the same ``default_rng`` draws in the same order (so byte-identical to
its inputs), through the port's public wrappers:

- exact Myers (``myers_edit_distance``, ``csrc/myers_full.cu``): 512
  problems of a 2,000-base genome against a copy with 10 % substitutions
  (``_align_problems``), in cells/s, P·L·N; the headline;
- banded Myers (``myers_banded``, ``csrc/myers_banded.cu``) on the same
  batch at 8 window words (band 256): alignments/s and band-cells/s;
- the banded Levenshtein wavefront (``banded_edit_distance``,
  ``csrc/banded_wavefront.cu``) on the same batch at band 256:
  band-cells/s;
- the chaining DP (``chain_dp``, ``csrc/chain_scan.cu``) on
  ``testing/chains.py::example_batch(2048, 64)`` packed once: pairs/s,
  B·K·K;
- seeding (``minimizer_torch.anchor_counts_bitmap`` against a bitmap of
  2^20 random hashes): reads/s of 10,240-base random reads;
- full device mapping (the six stages of ``ops/mapping_torch.py`` with the
  JAX bench's packed tail, budgets from ``device_bucket_budgets``) of 256
  such reads against a random 2^20-entry index: reads/s;
- a parity check (``_device_parity_check``): 64 simulated reads with 5 %
  noise mapped by ``map_all_with_device`` against ``map_read``, and the
  chaining phase with every bucket on ``chain_dp`` against the host
  oracle, edge for edge; anything but ``ok`` exits 1;
- the CPU baseline: the exact Myers figure at 32 problems on the CPU (the
  plain version), in a subprocess with no card visible; its failure exits
  non-zero.

Timing: a warm-up call, then one pair of CUDA events around n back-to-back
calls of the wrapper (n chosen so that a window lasts at least 50 ms), the
median of three windows; the window holds the wrappers' host work (their
length checks sync the card).  For each of the four kernels a line also
gives the device time of the kernels the wrapper launches (``torch.profiler``)
and the bound of ``utils/roofline.py`` on these inputs, with the share of
the bound that the call and the device time reach.  The run ends with its
wall, the kernels' build included where this process built them.

Output: ``[bench] <name>: <value>`` lines on standard error under the JAX
bench's names, with ``cuda`` (or ``cpu``) in place of its backend and of
``pallas`` (``scripts/gen_bench_table.py::parse_lines`` reads them), first
the card's name and power limit as ``nvidia-smi`` gives them; then, as the
last line of standard output, the JAX bench's JSON object ``{"metric",
"value", "unit", "vs_baseline"}``.  ``--device`` defaults to ``cuda``, and
without a card the run exits non-zero before any figure; ``--device cpu``
runs every figure through the kernels' plain versions.  ``--tiny`` runs the
figures at the CPU tests' sizes.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from muchsalsa_tpu_torch.assemble.host import build_graph, chaining_phase
from muchsalsa_tpu_torch.config import MapperConfig
from muchsalsa_tpu_torch.device import resolve_device
from muchsalsa_tpu_torch.io.fasta import SequenceStore
from muchsalsa_tpu_torch.io.paf import read_paf
from muchsalsa_tpu_torch.io.registry import Registry
from muchsalsa_tpu_torch.matching.edges import build_edges
from muchsalsa_tpu_torch.matching.store import MatchStore
from muchsalsa_tpu_torch.ops import mapping_torch as mt
from muchsalsa_tpu_torch.ops.align_torch import banded_edit_distance, pack_problems
from muchsalsa_tpu_torch.ops.chain_scan import chain_dp
from muchsalsa_tpu_torch.ops.chaining_torch import chaining_phase_device
from muchsalsa_tpu_torch.ops.minimizer_torch import anchor_counts_bitmap, build_hash_bitmap
from muchsalsa_tpu_torch.ops.myers_torch import myers_banded, myers_edit_distance
from muchsalsa_tpu_torch.pipeline.mapper import MinimizerIndex, device_bucket_budgets, map_read
from muchsalsa_tpu_torch.pipeline.mapper_torch import map_all_with_device
from muchsalsa_tpu_torch.state import pack_batch
from muchsalsa_tpu_torch.testing.chains import example_batch
from muchsalsa_tpu_torch.testing.simulate import add_noise, random_genome, simulate, write_simulation
from muchsalsa_tpu_torch.utils import roofline

REPO = Path(__file__).resolve().parent.parent
CHAIN_B, CHAIN_K = 2048, 64
ALIGN_P, ALIGN_L, ALIGN_BAND = 512, 2000, 256
WIGGLE = 300
SEED_R, SEED_L = 512, 10_240
MAP_R, MAP_L = 256, 10_240
INDEX_E = 1 << 20
BASELINE_P, BASELINE_CALLS = 32, 2
BASELINE_TIMEOUT_S = 600
WINDOW_MS = 50.0
WINDOWS = 3
MAX_CALLS = 100_000
# the CUDA kernels each wrapper launches, by name
KERNEL_NAMES = {
    "myers_full": ("myers_full_kernel",),
    "myers_banded": ("myers_banded_kernel", "order_pass", "order_offsets"),
    "banded_wavefront": ("wavefront_kernel",),
    "chain_dp": ("chain_dp",),
}


@dataclass(frozen=True)
class Sizes:
    """Every figure's size: the JAX bench's by default (``BENCH``)."""

    align_p: int = ALIGN_P
    align_l: int = ALIGN_L
    chain_b: int = CHAIN_B
    chain_k: int = CHAIN_K
    seed_r: int = SEED_R
    seed_l: int = SEED_L
    map_r: int = MAP_R
    map_l: int = MAP_L
    index_e: int = INDEX_E
    baseline_p: int = BASELINE_P


BENCH = Sizes()
TINY = Sizes(align_p=4, align_l=200, chain_b=8, chain_k=16, seed_r=4, seed_l=1024, map_r=4,
             map_l=1024, index_e=1 << 12, baseline_p=2)


@dataclass
class Timing:
    """One figure's timing: the median ms of one call over ``WINDOWS``
    windows of ``n`` calls; for a kernel on the card also its device ms
    and its bound on the figure's inputs."""

    name: str
    ms: float
    n: int
    device_ms: float | None = None
    bound_ms: float | None = None
    bound_by: str | None = None


def _window_ms(fn, dev: torch.device, n: int) -> float:
    """ms of one call in a window of ``n`` back-to-back calls: CUDA events
    on the card, the host clock on the CPU."""
    if dev.type == "cuda":
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def time_calls(fn, dev: torch.device, n: int | None = None) -> tuple[float, int]:
    """(median ms of one call, calls a window): a warm-up call, then
    ``WINDOWS`` windows of ``n`` calls, ``n`` by default enough for a
    window of ``WINDOW_MS`` by one more call's time."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if n is None:
        n = max(1, min(MAX_CALLS, math.ceil(WINDOW_MS / max(_window_ms(fn, dev, 1), 1e-6))))
    return statistics.median(_window_ms(fn, dev, n) for _ in range(WINDOWS)), n


def _timed(name: str, fn, dev: torch.device, timings: list | None, n: int | None = None,
           bound=None) -> Timing:
    """Time ``fn`` (``time_calls``); for a kernel on the card (``bound``, a
    function returning the bound's (ms, what)) also its device ms.  The
    timing goes into ``timings`` when given."""
    ms, n = time_calls(fn, dev, n)
    t = Timing(name, ms, n)
    if bound is not None and dev.type == "cuda":
        t.device_ms = roofline.device_ms(fn, KERNEL_NAMES[name])
        t.bound_ms, t.bound_by = bound()
    if timings is not None:
        timings.append(t)
    return t


def _align_problems(n_problems: int = ALIGN_P, length: int = ALIGN_L):
    """The JAX bench's edit-distance batch (``bench.py::_align_problems``):
    ``n_problems`` random genomes of ``length`` bases from
    ``default_rng(0)``, each against a copy with about 10 % of its bases
    drawn again, packed as CPU tensors."""
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for _ in range(n_problems):
        q = random_genome(rng, length)
        t = np.frombuffer(q, dtype=np.uint8).copy()
        flip = rng.random(len(t)) < 0.1
        t[flip] = bases[rng.integers(0, 4, int(flip.sum()))]
        pairs.append((q, t.tobytes()))
    return pack_problems(pairs)


def _align_bound(name: str, args, kw: dict):
    return lambda: roofline.align_bound(name, args, kw, roofline.card_int32_rate()[2])


def _bench_myers(device, n_problems: int = ALIGN_P, length: int = ALIGN_L, *,
                 n: int | None = None, timings: list | None = None) -> tuple[float, int]:
    """Exact edit distance on ``device``: (cells/s, the distances' sum)."""
    dev = resolve_device(device)
    args = tuple(x.to(dev) for x in _align_problems(n_problems, length))
    checksum = int(myers_edit_distance(*args).sum())
    t = _timed("myers_full", lambda: myers_edit_distance(*args), dev, timings, n,
               _align_bound("myers_full", args, {}))
    return n_problems * length * args[2].shape[1] / (t.ms / 1e3), checksum


def _bench_myers_banded(device, n_problems: int = ALIGN_P, length: int = ALIGN_L,
                        band: int = ALIGN_BAND, *, timings: list | None = None
                        ) -> tuple[float, int]:
    """Banded Myers at ``band // 32`` window words: (alignments/s, the
    distances' sum, -1s included); band-cells/s is alignments/s x length x
    band."""
    dev = resolve_device(device)
    args = tuple(x.to(dev) for x in _align_problems(n_problems, length))
    kw = {"window_words": band // 32}
    checksum = int(myers_banded(*args, **kw).sum())
    t = _timed("myers_banded", lambda: myers_banded(*args, **kw), dev, timings,
               bound=_align_bound("myers_banded", args, kw))
    return n_problems / (t.ms / 1e3), checksum


def _bench_align(device, n_problems: int = ALIGN_P, length: int = ALIGN_L,
                 band: int = ALIGN_BAND, *, timings: list | None = None) -> tuple[float, int]:
    """The banded Levenshtein wavefront: (band-cells/s, counting P·M·band
    cells, and the distances' sum, -1s included)."""
    dev = resolve_device(device)
    args = tuple(x.to(dev) for x in _align_problems(n_problems, length))
    kw = {"band": band}
    checksum = int(banded_edit_distance(*args, **kw).sum())
    t = _timed("banded_wavefront", lambda: banded_edit_distance(*args, **kw), dev, timings,
               bound=_align_bound("banded_wavefront", args, kw))
    return n_problems * args[0].shape[1] * band / (t.ms / 1e3), checksum


def _bench_chain_dp(device, B: int = CHAIN_B, K: int = CHAIN_K, *,
                    timings: list | None = None) -> tuple[float, float]:
    """The chaining DP on ``example_batch(B, K)`` packed once: (pairs/s,
    B·K·K, and the sum of the scores plus the sum of the backpointers)."""
    dev = resolve_device(device)
    packed = [x.to(dev) for x in pack_batch(example_batch(B, K, np.float64))]
    scores, bps = chain_dp(*packed, K, WIGGLE)
    checksum = float(scores.sum()) + float(bps.sum())
    t = _timed("chain_dp", lambda: chain_dp(*packed, K, WIGGLE), dev, timings,
               bound=lambda: roofline.dp_bound(packed[2], K))
    return B * K * K / (t.ms / 1e3), checksum


def _seeding_inputs(R: int = SEED_R, L: int = SEED_L, E: int = INDEX_E):
    """The JAX bench's seeding inputs from ``default_rng(0)``: (R, L) uint8
    codes, (R,) int32 lengths, E uint32 index hashes."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    lens = np.full(R, L, dtype=np.int32)
    return codes, lens, rng.integers(0, 1 << 32, E, dtype=np.uint32)


def _bench_seeding(device, R: int = SEED_R, L: int = SEED_L, E: int = INDEX_E, *,
                   timings: list | None = None) -> tuple[float, int]:
    """The seeding stage, sketch and bitmap probe: (reads/s, the anchor
    counts' sum)."""
    dev = resolve_device(device)
    codes, lens, hashes = _seeding_inputs(R, L, E)
    codes, lens = torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev)
    bitmap = build_hash_bitmap(hashes, device=dev)
    checksum = int(anchor_counts_bitmap(codes, lens, bitmap).sum())
    t = _timed("mapping seed+join", lambda: anchor_counts_bitmap(codes, lens, bitmap), dev,
               timings)
    return R / (t.ms / 1e3), checksum


def _mapping_inputs(R: int = MAP_R, L: int = MAP_L, E: int = INDEX_E):
    """The JAX bench's full-mapping inputs from ``default_rng(0)``: (R, L)
    uint8 codes, (R,) int32 lengths, and the index arrays that
    ``build_device_tables`` takes (the distinct hashes of E draws, one entry
    each: offsets, unitigs, positions, strands)."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    lens = np.full(R, L, dtype=np.int32)
    hashes = np.unique(np.sort(rng.integers(0, 1 << 32, E, dtype=np.uint32)))
    H = len(hashes)
    index = (hashes, np.arange(H + 1, dtype=np.int64),
             rng.integers(0, 5000, H).astype(np.int32),
             rng.integers(0, 1000, H).astype(np.int32),
             rng.random(H) < 0.5)
    return codes, lens, index


def _bench_full_mapping(device, R: int = MAP_R, L: int = MAP_L, E: int = INDEX_E, *,
                        timings: list | None = None) -> tuple[float, int]:
    """The six stages of device mapping with the JAX bench's packed tail,
    the tables and packed reads already on ``device``: (reads/s, the packed
    hits' sum)."""
    dev = resolve_device(device)
    codes, lens, index = _mapping_inputs(R, L, E)
    built = mt.build_device_tables(*index, device=dev)
    if built is None:
        raise RuntimeError("the v2 tables refused the benchmark's random index")
    tables, hash_takes = built
    packed, nmask = mt.pack_codes(codes, device=dev)
    lens = torch.from_numpy(lens).to(dev)
    max_sel, max_pos, trim = device_bucket_budgets(L, 15, 2048, 4)

    def chain():
        return mt.pack_hits(mt.map_reads_device_v2_packed(
            packed, nmask, lens, *tables, max_sel=max_sel, max_pos=max_pos, max_per_hit=4,
            hash_takes=hash_takes, trim=trim))

    checksum = int(chain().sum())
    t = _timed("FULL device mapping", chain, dev, timings)
    return R / (t.ms / 1e3), checksum


def _device_parity_check(device) -> str:
    """The JAX bench's parity check on ``device``: 64 reads of a 60 kb
    simulation (``default_rng(20260819)``, 5x of 2 kb reads) with 5 % noise
    mapped by ``map_all_with_device`` must equal ``map_read`` read for read,
    and the chaining phase with every bucket on ``chain_dp`` must give every
    edge the host oracle's shadow flag and orders.  Returns ``ok`` or the
    first divergence."""
    dev = resolve_device(device)
    rng = np.random.default_rng(20260819)
    sim = simulate(rng, genome_length=60_000, coverage=5.0, read_length=2_000)
    unitigs = SequenceStore()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    reads = SequenceStore()
    for i, (name, seq) in enumerate(sim.read_records()):
        if i >= 64:
            break
        reads.add(name, add_noise(rng, seq, 0.05))
    cfg = MapperConfig()
    index = MinimizerIndex.build(unitigs, cfg)
    mapped = map_all_with_device(index, reads, cfg, max_pos=1024, max_per_hit=4, device=dev)
    if not mapped:
        return "mapping parity check had no reads"
    for rid, maps in mapped:
        if maps != map_read(index, reads.sequence(rid), cfg):
            return f"mapping device/host diverged on read {rid} ({reads.description(rid)})"

    with tempfile.TemporaryDirectory(prefix="ms_bench_parity_") as td:
        paths = write_simulation(sim, td)
        records = read_paf(paths["paf"], registry_nanopore=Registry(),
                           registry_illumina=Registry())
    store = MatchStore.from_paf(records)
    em = build_edges(store)

    def run(phase):
        graph = build_graph(store, em)
        phase(graph, store, em, WIGGLE)
        return {(e.v, e.w): (e.shadow, tuple(e.orders)) for e in graph.edges()}

    placed = {}
    on_device = run(lambda *a: placed.update(
        chaining_phase_device(*a, min_device_batch=1, device=dev)))
    if not placed["device_problems"]:
        return "no chaining problem ran on the device"
    if on_device != run(chaining_phase):
        return "chaining device (f64) diverged from the host f64 oracle"
    return "ok"


def _cpu_baseline(tiny: bool) -> float:
    """The exact Myers figure at ``baseline_p`` problems on the CPU, in a
    subprocess that sees no card; raises where it fails."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(filter(None, (str(REPO), os.environ.get("PYTHONPATH")))))
    cmd = [sys.executable, "-m", "muchsalsa_tpu_torch.bench", "--device", "cpu", "--cpu-baseline"]
    proc = subprocess.run(cmd + (["--tiny"] if tiny else []), capture_output=True, text=True,
                          timeout=BASELINE_TIMEOUT_S, cwd=REPO, env=env)
    if proc.returncode != 0:
        raise RuntimeError(f"exit {proc.returncode}: {proc.stderr[-2000:]}")
    return float(proc.stdout.strip().splitlines()[-1])


def _say(text: str) -> None:
    print(f"[bench] {text}", file=sys.stderr, flush=True)


def _card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, and the
    device count; or the CPU's plain versions."""
    if dev.type != "cuda":
        return "cpu (the kernels' plain versions), count 0"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return f"{smi.splitlines()[0].strip()}, count {torch.cuda.device_count()}"


def _say_timing(t: Timing, dev: torch.device) -> None:
    line = (f"{t.name} timing: call {t.ms:.4f} ms (median of {WINDOWS} windows of {t.n} "
            f"calls) on {dev.type}")
    if t.bound_ms is not None:
        line += (f", device {f'{t.device_ms:.4f} ms' if t.device_ms else 'not measured'}, "
                 f"bound {t.bound_ms:.5f} ms ({t.bound_by}), {t.bound_ms / t.ms:.1%} of the call")
        if t.device_ms:
            line += f", {t.bound_ms / t.device_ms:.1%} of the device time"
    _say(line)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m muchsalsa_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the figures run (default cuda; no card: exit 1)")
    ap.add_argument("--tiny", action="store_true", help="the CPU tests' sizes")
    ap.add_argument("--cpu-baseline", action="store_true",
                    help="print the CPU baseline's cells/s alone (the subprocess's role)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 1
    sizes = TINY if args.tiny else BENCH
    if args.cpu_baseline:
        print(_bench_myers(dev, sizes.baseline_p, sizes.align_l, n=BASELINE_CALLS)[0])
        return 0

    on = dev.type
    _say(f"device: {_card(dev)}")
    timings: list[Timing] = []

    def figure(line: str) -> None:
        _say(line)
        _say_timing(timings[-1], dev)

    myers, _ = _bench_myers(dev, sizes.align_p, sizes.align_l, timings=timings)
    figure(f"Myers exact DP on {on}: {myers / 1e9:.1f} GCUPS")
    aligns, _ = _bench_myers_banded(dev, sizes.align_p, sizes.align_l, timings=timings)
    figure(f"banded Myers ({on}) on {on}: {aligns / 1e6:.2f} M alignments/s "
           f"({aligns * sizes.align_l * ALIGN_BAND / 1e9:.0f} G band-cells/s, "
           f"{sizes.align_l / 1000:g}kb pairs, band {ALIGN_BAND})")
    pairs, _ = _bench_chain_dp(dev, sizes.chain_b, sizes.chain_k, timings=timings)
    figure(f"chain DP on {on}: {pairs / 1e9:.3f} G pairs/s")
    seeds, _ = _bench_seeding(dev, sizes.seed_r, sizes.seed_l, sizes.index_e, timings=timings)
    figure(f"mapping seed+join on {on}: {seeds:.0f} reads/s "
           f"({sizes.seed_l / 1024:g}kb reads, {sizes.index_e / 2**20:g}M-entry index)")
    reads, _ = _bench_full_mapping(dev, sizes.map_r, sizes.map_l, sizes.index_e, timings=timings)
    figure(f"FULL device mapping on {on} (production 6-stage split): {reads:.0f} reads/s "
           f"({sizes.map_l / 1024:g}kb reads, {sizes.index_e / 2**20:g}M-entry index)")

    parity = _device_parity_check(dev)
    _say(f"device parity (mapping + f64 chaining vs host oracle): {parity}")
    if parity != "ok":
        return 1

    cells, _ = _bench_align(dev, sizes.align_p, sizes.align_l, timings=timings)
    figure(f"banded wavefront ({on}): {cells / 1e9:.1f} G band-cells/s")

    try:
        cpu_cells = _cpu_baseline(args.tiny)
    except (RuntimeError, ValueError, IndexError, subprocess.TimeoutExpired) as exc:
        _say(f"cpu baseline failed: {exc}")
        return 1
    _say(f"Myers exact DP on cpu: {cpu_cells / 1e9:.3f} GCUPS")
    _say(f"wall: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"metric": "myers_edit_distance_gcups", "value": round(myers, 1),
                      "unit": "cells/s", "vs_baseline": round(myers / cpu_cells, 3)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
