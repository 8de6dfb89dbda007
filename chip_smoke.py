#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's core assembler, its mapper (device mapping
by the v2 and the v1 join, and refinement), its full pipeline, and its
sharded and multi-process paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without its last line:

0. setup   — requires a CUDA device; prints the card's name and power limit
             as nvidia-smi gives them;
1. build   — builds the kernel library from csrc/ (nvcc), prints seconds
             and ptxas' register/shared-memory/spill report, and the card's
             SM count and maximum SM clock (nvidia-smi clocks.max.sm), from
             which every kernel's bound is computed;
2. kernels — chain_scan (CUDA) against chain_scan_reference (plain PyTorch)
             on the card at K in {8, 16, 32, 64, 128} x B in {1, 33, 4096},
             and B = 65536 at K = 32; random asymmetric, all-true (tying)
             and all-false compat with -1e30 holes; then the fused chain_dp
             against chain_dp_reference at the same shapes on random
             anchors, boundary anchors (diff == wiggle_room, rel == 15.0,
             mx == 0, ties), all-padding rows and inverted anchors (a
             corrected range with hi < lo, where the pair order (k, l)
             matters), and the two-anchor input that only the order (k, l)
             leaves unchained (scores 500 and 700); bit-equal required;
             median CUDA-event times of both;
3. golden  — the port's assemble(device="cuda", min_device_batch=1, both
             placement gates at 0) on the dataset of tests/test_golden.py
             must reproduce its sha256s, chain_dp launched;
4. core    — an E. coli-scale core (4.6 Mb, 15x) through the port on the
             card with both placement gates at 0 (the measured default
             keeps phase 2, edges, on the host at this size; the line gives
             the match rows and 2 x graph size and the default's decision
             for each), chain_dp launched, byte-identical to the host oracle:
             the port's assemble with config.device.use_device unset, which
             runs the host edges and chaining and puts nothing on the card;
             the packed batches the port's run gave chain_dp are kept;
5. shapes  — chain_dp against chain_dp_reference, and chain_scan against
             chain_scan_reference on the same batch's compatibility, on the
             very batches phase 4's core built, timed, each with its bound;
6. align_kernels — the three edit-distance kernels (exact Myers, banded
             Myers at 2, 4 and 8 window words, the wavefront at bands 128
             and 256) against their plain versions on the card, on random
             pairs mutated at 0-30 % with Ns, empty queries and unrelated
             lengths, at M in {31, 32, 33, 200, 1000, 4096} x P in {1, 33,
             4096}, and the exact kernel alone at M = 9000 (past its register
             classes) x P in {1, 33}; bit-equal required; median CUDA-event
             times at the largest P (at M >= 4096, where one plain call takes
             seconds, the comparison's own plain call is the one timed);
7. refine  — phase 4's unitigs and reads with 8 % nanopore-style noise,
             mapped by the port's map_all with cfg.refine on the card (the
             refinement of `full`'s map stages), then refine_mappings'
             wavefront engine with the banded Myers kernel and with the
             wavefront kernel; a sample of the exact distances against the
             host's big-int Myers; then each kernel against its plain version
             on the very arrays the map_all path packed, with its bound; the
             gather that builds refinement's batch from coordinates
             (csrc/refine_gather.cu) against its plain version and against
             pack_problems of the pairs sliced on the host, on these
             mappings (its one launch in map_all counted) and on a synthetic
             batch of a refined E. coli map stage's size (~57,000 problems
             of 0.5-10 kb), each timed beside its byte bound;
8. device_map — the same unitigs and reads through the port's
             map_all(device=True) on the card, identical to its host map_all
             with refinement off and on (the exact Myers kernel launched), a
             second call served by the store's batch cache, a repeat-rich set
             whose reads take tier 2 (identical, tier2_reads > 0); the v2
             tables required; the six stages' median CUDA-event times on one
             full batch of the largest bucket; peak CUDA memory;
9. full    — phase 4's genome as raw reads (Illumina pairs at 25x, phase 7's
             noisy long reads) through the port's run_full_pipeline with
             mapper.refine on: every device leg on the card (mapping, the
             k-mer filter's counting, the DBG extension table, the scrub's
             all-vs-all), then all four on the host as the oracle
             (refinement and the core's chaining on the card in both); the
             filtered reads, unitigs, scrubbed reads, three PAFs and
             03.assembly.unpolished.fa byte-identical, at least one contig,
             chain_dp and myers_full launched on the device run, k-mer
             chunks and DBG extension rows counted on the card, at least one
             scrub subset on the card and none declined by its guard, no jax
             loaded; stage walls (the three legs' side by side), each scrub
             subset's multiplicity and index chunks, the report's device
             lines, both walls and peak CUDA memory;
10. join_v1 — a 140 Mb random genome in 1 kb unitigs (the JAX package's
             largest tier), whose index the v2 tables must refuse, and 2,048
             reads of 9 kb from both strands with 8 % noise, through the
             port's map_all(device=True) on the card: the v1 join (bitmap
             probe, compaction, binary search, expansion, the chaining tail)
             identical to host mapping with refinement off and on (both
             refining on the card, the exact Myers kernel launched), v2 off
             and fewer overflow reads than reads; the host index and
             join-table builds, the bytes of the index and the bitmap on the
             card, peak CUDA memory, and the median CUDA-event ms of the
             join's four parts on one full batch;
11. multi  — two shards and two processes on the one card, no dimension
             cut: with ``parallel.mesh.visible_devices`` listing cuda:0
             twice, ``sharded_chain_dp`` on phase 4's largest batch and
             ``sharded_myers`` on phase 7's regions bit-equal to one launch
             of each kernel (two launches each, the chain stats equal to a
             host sum), phase 4's core byte-identical to phase 4's port run
             (``mesh_devices`` 2, two ``chain_dp`` launches a bucket; here and
             in the processes below both placement gates at 0) and
             phase 8's reads mapped on the card identical to host mapping
             (meshed, no tier 2); then ``scripts/torch_distributed_core.py``
             in two gloo processes on the card, each writing phase 4's port
             output, and ``scripts/torch_distributed_scrub.py`` on phase 8's
             reads and mapping (subsets of 2,000 reads, at least one on the
             card) byte-identical to one in-process ``scrub_reads`` on the
             card; each wall beside its unsharded or single-process
             counterpart.
12. scale  — the 1 Mb row of ``testing/scale.py::SCALE_ROWS``: the JAX
             package's ``scripts/scale_run.py`` inputs made by the port's
             ``make_scale_inputs`` (12x nanopore reads at 7 % noise, a
             fifth with junk tails, 30x Illumina pairs) through the port's
             ``full`` with every leg on the card and both placement gates
             at 0 (``run_scale_row``); the three inputs' and the assembly's
             sha256 and the contig statistics equal to the row's, chain_dp
             launched, no jax loaded; stage walls, peak CUDA memory, the
             legs' counters and each map stage's overflow and tier-2 reads.
             Then the same row again (``scale_v1``) with the map stages'
             ``build_device_tables`` refusing, as from ~60 Mb up: every map
             stage on the v1 join (``v2`` False), the same hashes.

Then the whole run's seconds (``done``), the kernel summary line (each
kernel's launches on its path, error, kernel and plain times, bound and
what bounds it, and the library yardstick: none of the five functions is
one PyTorch call; chain_scan, the scan alone
over a given matrix, is on no path of the port since chain_dp fused it with
the compatibility build, so its launches are 0), and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Each path's launch counts are reset to 0 just before it runs and read just
after, and must be > 0 for the kernels that path runs; launches made for
comparison do not count.
"""

from __future__ import annotations

import atexit
import dataclasses
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from muchsalsa_tpu_torch.utils.roofline import (
    FP64_FLOPS, HBM_BYTES_PER_S, align_bound, card_int32_rate, dp_bound, gather_bound, median_ms,
    scan_bound)

OUTPUTS = ("temp_1.target.fa", "temp_1.query.fa", "temp_1.align.paf")
BUCKETS = (8, 16, 32, 64, 128)
PHASE2_SHAPES = [(B, K) for K in BUCKETS for B in (1, 33, 4096)] + [(65536, 32)]
ALIGN_M = (31, 32, 33, 200, 1000, 4096, 9000)
ALIGN_P = (1, 33, 4096)
LONG_M = 9000        # past the exact kernel's register classes: that kernel only, small P
LONG_P = (1, 33)
WINDOW_WORDS = (2, 4, 8)
BANDS = (128, 256)
REFINE_BAND = 256
# both placement gates at 0: the card path at any size, as a phase that
# holds a kernel must launch it
GATES_OPEN = {"edges_device_min_rows": 0, "chain_device_min_problems": 0}


def load_test_module(name: str):
    """A module of tests/ loaded by path: the directory has no __init__.py,
    so an installed package named ``tests`` would shadow it on import."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def golden_hashes() -> dict[str, str]:
    """``GOLDEN`` of tests/test_golden.py, read from its source without
    running the module (it imports the JAX package's driver)."""
    import ast

    tree = ast.parse((Path(__file__).resolve().parent / "tests" / "test_golden.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and [getattr(t, "id", None) for t in node.targets] == ["GOLDEN"]:
            return ast.literal_eval(node.value)
    raise LookupError("tests/test_golden.py defines no GOLDEN")


def assert_no_reference(what: str) -> None:
    """Raise if JAX or any module of the JAX package is loaded."""
    loaded = sorted(m for m in sys.modules if m in ("jax", "muchsalsa_tpu")
                    or m.startswith(("jax.", "muchsalsa_tpu.")))
    if loaded:
        raise AssertionError(f"{what} loaded {loaded[:8]}")


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line of a phase; ``t_s`` is the seconds since the script
    started, so that each phase's share of the run can be read."""
    print(json.dumps({"phase": phase, **fields, "t_s": time.perf_counter() - _T0}), flush=True)


def compare_scan(c: torch.Tensor, i: torch.Tensor, kind: str, timed: bool) -> dict:
    """chain_scan vs its plain version on CUDA tensors; raises unless
    bit-equal."""
    from muchsalsa_tpu_torch.ops.chain_scan import chain_scan, chain_scan_reference

    B, K = i.shape
    s, b = chain_scan(c, i)
    s_ref, b_ref = chain_scan_reference(c, i)
    torch.cuda.synchronize()
    err = float((s - s_ref).abs().max()) if s.numel() else 0.0
    if not (torch.equal(s, s_ref) and torch.equal(b, b_ref)):
        raise AssertionError(
            f"chain_scan disagrees with its plain version at B={B} K={K} {kind}: "
            f"max_abs_err={err}, bp mismatches={int((b != b_ref).sum())}")
    row = {"kernel": "chain_scan", "B": B, "K": K, "kind": kind, "max_abs_err": err}
    row["bound_ms"], row["bound_by"] = scan_bound(B, K)
    if timed:
        row["ms"] = median_ms(lambda: chain_scan(c, i), reps=20)
        row["plain_ms"] = median_ms(lambda: chain_scan_reference(c, i), reps=5)
    return row


def compare_dp(packed: list[torch.Tensor], K: int, wiggle_room: int, kind: str,
               timed: bool) -> dict:
    """chain_dp vs its plain version on a packed batch of CUDA tensors
    (fields, flags, offsets); raises unless bit-equal."""
    from muchsalsa_tpu_torch.ops.chain_scan import chain_dp, chain_dp_reference

    B, N = packed[2].shape[0] - 1, packed[0].shape[1]
    s, b = chain_dp(*packed, K, wiggle_room)
    s_ref, b_ref = chain_dp_reference(*packed, K, wiggle_room)
    torch.cuda.synchronize()
    err = float((s - s_ref).abs().max()) if s.numel() else 0.0
    if not (torch.equal(s, s_ref) and torch.equal(b, b_ref)):
        raise AssertionError(
            f"chain_dp disagrees with its plain version at B={B} K={K} {kind}: "
            f"max_abs_err={err}, bp mismatches={int((b != b_ref).sum())}")
    row = {"kernel": "chain_dp", "B": B, "K": K, "N": N, "kind": kind, "max_abs_err": err}
    row["bound_ms"], row["bound_by"] = dp_bound(packed[2], K)
    if timed:
        row["ms"] = median_ms(lambda: chain_dp(*packed, K, wiggle_room), reps=20)
        row["plain_ms"] = median_ms(lambda: chain_dp_reference(*packed, K, wiggle_room), reps=5)
    return row


def align_cases():
    """(name, kernel, plain version, keyword arguments) of every
    edit-distance kernel configuration phase 6 checks."""
    from muchsalsa_tpu_torch.ops.align_torch import (
        banded_edit_distance, banded_edit_distance_reference)
    from muchsalsa_tpu_torch.ops.myers_torch import (
        myers_banded, myers_banded_reference, myers_edit_distance,
        myers_edit_distance_reference)

    return ([("myers_full", myers_edit_distance, myers_edit_distance_reference, {})]
            + [("myers_banded", myers_banded, myers_banded_reference, {"window_words": wb})
               for wb in WINDOW_WORDS]
            + [("banded_wavefront", banded_edit_distance, banded_edit_distance_reference,
                {"band": b}) for b in BANDS])


def compare_align(name, kernel, plain, args, kw, timed: bool, int32_ops_per_s: float,
                  plain_reps: int = 3) -> dict:
    """Kernel vs plain version on the same CUDA tensors, with the kernel's
    bound on them; raises unless bit-equal.  The comparison's own call warms
    the plain version up, or, with ``plain_reps`` 1 (shapes where one plain
    call takes seconds), is the one plain call timed."""
    got = kernel(*args, **kw)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(*args, **kw)
    stop.record()
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(
            f"{name} {kw} disagrees with its plain version at P={args[0].shape[0]} "
            f"M={args[0].shape[1]} N={args[2].shape[1]}: max_abs_err={err}, "
            f"mismatches={int((got != want).sum())}")
    row = {"kernel": name, **kw, "P": args[0].shape[0], "M": args[0].shape[1],
           "N": args[2].shape[1], "max_abs_err": err, "refused": int((got < 0).sum())}
    row["bound_ms"], row["bound_by"] = align_bound(name, args, kw, int32_ops_per_s)
    if timed:
        row["ms"] = median_ms(lambda: kernel(*args, **kw), reps=10)
        row["plain_ms"] = (start.elapsed_time(stop) if plain_reps == 1 else
                           median_ms(lambda: plain(*args, **kw), reps=plain_reps, warmup=0))
    return row


def compare_gather(card: str, name: str, args, M: int, N: int, pairs=None) -> dict:
    """The gather kernel against its plain version on the card (and, given
    ``pairs``, against ``pack_problems`` of them on the host), timed beside
    its byte bound; raises unless bit-equal."""
    from muchsalsa_tpu_torch.ops.align_torch import (
        gather_problems, gather_problems_reference, pack_problems)

    on_card = args.to("cuda")
    before = gather_problems.launches
    got = gather_problems(*on_card, M, N)
    torch.cuda.synchronize()
    if gather_problems.launches != before + 1:
        raise AssertionError(f"gather_problems ({name}) did not launch its kernel")
    wants = [("plain", gather_problems_reference(*on_card, M, N))]
    if pairs is not None:
        wants.append(("pack_problems", tuple(x.cuda() for x in pack_problems(pairs))))
    for what, want in wants:
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"refine_gather ({name}) disagrees with {what}")
    P = on_card.q_len.numel()
    row = {"kernel": "refine_gather", "batch": name, "P": P, "M": M, "N": N,
           "bytes": int(on_card.q_len.sum()) + int(on_card.t_len.sum()),
           "checked": [w for w, _ in wants]}
    row["bound_ms"], row["bound_by"] = gather_bound(on_card.q_len, on_card.t_len, M, N)
    row["ms"] = median_ms(lambda: gather_problems(*on_card, M, N), reps=20)
    row["plain_ms"] = median_ms(lambda: gather_problems_reference(*on_card, M, N), reps=3)
    row["share"] = row["bound_ms"] / row["ms"]
    emit("refine_gather", card=card, **row)
    return row


def reset_align_launches() -> None:
    from muchsalsa_tpu_torch.ops.align_torch import banded_edit_distance, gather_problems
    from muchsalsa_tpu_torch.ops.myers_torch import myers_banded, myers_edit_distance

    for fn in (myers_edit_distance, myers_banded, banded_edit_distance, gather_problems):
        fn.launches = 0


def phase_align_kernels(card: str, device, int32_ops_per_s: float) -> dict[str, int]:
    """Phase 6: every edit-distance kernel configuration against its plain
    version at the ALIGN_M x ALIGN_P shapes (the exact kernel alone at
    LONG_M x LONG_P); returns the largest error of each kernel."""
    from muchsalsa_tpu_torch.ops.align_torch import pack_problems
    from muchsalsa_tpu_torch.testing.pairs import random_pairs

    align_err = {"myers_full": 0, "myers_banded": 0, "banded_wavefront": 0}
    for M in ALIGN_M:
        sizes = LONG_P if M == LONG_M else ALIGN_P
        cases = [c for c in align_cases() if M != LONG_M or c[0] == "myers_full"]
        for P in sizes:
            pairs = random_pairs(np.random.default_rng(M * 10_000 + P), P, M)
            args = tuple(x.to(device) for x in pack_problems(pairs))
            for name, kernel, plain, kw in cases:
                # at M >= 4096 one plain call takes seconds: time the check's own
                row = compare_align(name, kernel, plain, args, kw, timed=P == max(sizes),
                                    int32_ops_per_s=int32_ops_per_s,
                                    plain_reps=1 if M >= 4096 else 3)
                align_err[name] = max(align_err[name], row["max_abs_err"])
                emit("align_kernels", card=card, **row)
    return align_err


def phase_refine(card: str, sim, device, align_err: dict[str, int], int32_ops_per_s: float):
    """Phase 7: the simulation's unitigs and noisy reads through the port's
    map_all with refinement on ``device``, then refine_mappings' wavefront
    engine with each of its kernels, a sample against the host oracle, and
    every kernel against its plain version on the arrays map_all packed.
    Returns (launches of each kernel on its path, timing rows, the mapping
    data: unitigs, noisy reads, config, index and PAF names, and a host copy
    of the packed regions)."""
    from muchsalsa_tpu_torch.config import Config
    from muchsalsa_tpu_torch.ops.align_torch import banded_edit_distance, gather_problems
    from muchsalsa_tpu_torch.ops.myers_torch import myers_banded, myers_edit_distance
    from muchsalsa_tpu_torch.pipeline.mapper_torch import (
        MinimizerIndex, SequenceStore, map_all, map_batch, problem_coordinates, refine_mappings)
    from muchsalsa_tpu_torch.testing.pairs import gather_scale_inputs, myers_bigint
    from muchsalsa_tpu_torch.utils.seq import reverse_complement
    from muchsalsa_tpu_torch.testing.simulate import add_noise

    t0 = time.perf_counter()
    unitigs, reads = SequenceStore(), SequenceStore()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    noise_rng = np.random.default_rng(1)
    for name, seq in sim.read_records():
        reads.add(name, add_noise(noise_rng, seq, 0.08))
    data_s = time.perf_counter() - t0
    cfg = dataclasses.replace(Config().mapper, refine=True, refine_band=REFINE_BAND)
    t0 = time.perf_counter()
    index = MinimizerIndex.build(unitigs, cfg)
    index_s = time.perf_counter() - t0
    names = dict(unitig_names=lambda u: unitigs.registry.name(u),
                 read_names=lambda r: reads.registry.name(r))

    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    reset_align_launches()
    t0 = time.perf_counter()
    lines = map_all(index, reads, cfg, unitigs=unitigs, device=False, torch_device=device,
                    stats=stats, **names)
    map_all_s = time.perf_counter() - t0
    refine_launches = {"myers_full": myers_edit_distance.launches,
                       "myers_banded": myers_banded.launches,
                       "banded_wavefront": banded_edit_distance.launches,
                       "refine_gather": gather_problems.launches}
    assert_no_reference("the port's map_all")
    if refine_launches["myers_full"] == 0:
        raise AssertionError("map_all with cfg.refine never launched the exact Myers kernel")
    if refine_launches["refine_gather"] != 1 or stats["card_packed"] != stats["problems"]:
        raise AssertionError(f"refinement built {stats['card_packed']} of {stats['problems']} "
                             f"problems on the card in {refine_launches['refine_gather']} "
                             "gather launches, not 1")
    peak = torch.cuda.max_memory_allocated()
    unrefined = map_all(index, reads, dataclasses.replace(cfg, refine=False), device=False,
                        **names)
    if len(unrefined) != len(lines) or len(lines) != stats["problems"]:
        raise AssertionError(f"{len(lines)} refined lines, {len(unrefined)} unrefined, "
                             f"{stats['problems']} problems")
    changed = sum(a.split("\t")[9] != b.split("\t")[9] for a, b in zip(lines, unrefined))
    for ln in lines:
        c = ln.split("\t")
        if not 0 <= int(c[9]) <= int(c[10]):
            raise AssertionError(f"refined matches outside [0, block]: {ln}")

    # the wavefront engine's two kernels, each through refine_mappings
    per_read = map_batch(index, reads, cfg)
    wavefront_runs = {}
    for kernel_name, use_pallas in (("myers_banded", True), ("banded_wavefront", False)):
        maps = [(rid, [dataclasses.replace(m) for m in ms]) for rid, ms in per_read]
        reset_align_launches()
        t0 = time.perf_counter()
        refine_mappings(maps, reads, unitigs, band=REFINE_BAND, engine="wavefront",
                        use_pallas=use_pallas, device=device)
        wall = time.perf_counter() - t0
        launched = {"myers_full": myers_edit_distance.launches,
                    "myers_banded": myers_banded.launches,
                    "banded_wavefront": banded_edit_distance.launches}
        if launched[kernel_name] == 0:
            raise AssertionError(f"refine_mappings(engine='wavefront', use_pallas={use_pallas}) "
                                 f"never launched {kernel_name}")
        refine_launches[kernel_name] = launched[kernel_name]
        wavefront_runs[kernel_name] = {"use_pallas": use_pallas, "wall_s": wall,
                                       "launches": launched}

    # a sample of the exact distances against the host's big-int Myers
    dists = myers_edit_distance(*stats["packed"]).cpu().numpy()
    alphabet = np.frombuffer(b"ACGTN", dtype=np.uint8)
    sample = np.random.default_rng(7).choice(len(dists), size=min(256, len(dists)),
                                             replace=False)
    qs, ql, ts, tl = (x.cpu().numpy() for x in stats["packed"])
    for i in sample:
        q = alphabet[qs[i, :ql[i]]].tobytes()
        t = alphabet[ts[i, :tl[i]]].tobytes()
        if b"N" in q or b"N" in t:
            raise AssertionError("the simulated reads hold no N")
        if myers_bigint(q, t) != dists[i]:
            raise AssertionError(f"problem {i}: kernel {dists[i]}, host {myers_bigint(q, t)}")

    emit("refine", card=card, problems=stats["problems"], M=stats["M"], N=stats["N"],
         reads=len(reads.ids()), unitigs=len(unitigs.ids()), noise_s=data_s,
         index_s=index_s, map_s=stats["map_s"], pack_s=stats["pack_s"],
         distance_s=stats["distance_s"], refine_s=stats["refine_s"], map_all_s=map_all_s,
         lines=len(lines), changed_matches=changed, host_checked=len(sample),
         launches=refine_launches, wavefront_runs=wavefront_runs, cuda_peak_bytes=peak)

    slice_rows = {}
    packed = stats["packed"]
    for name, kernel, plain, kw in align_cases():
        if name == "myers_banded" and kw["window_words"] != REFINE_BAND // 32:
            continue
        if name == "banded_wavefront" and kw["band"] != REFINE_BAND:
            continue
        row = compare_align(name, kernel, plain, packed, kw, timed=True,
                            int32_ops_per_s=int32_ops_per_s)
        align_err[name] = max(align_err[name], row["max_abs_err"])
        slice_rows[name] = row
        emit("refine_kernels", card=card, **row)

    # the gather on these mappings' coordinates (the batch map_all built),
    # held to the host's packing of the pairs sliced in Python, then on a
    # synthetic batch of the size and widths of the benchmark's refined
    # E. coli map stage
    slots, coords = problem_coordinates(per_read, reads, unitigs)
    pairs = []
    for rid, maps in per_read:
        for m in maps:
            t = reads.sequence(rid)[m.t_start : m.t_end]
            pairs.append((unitigs.sequence(m.unitig)[m.q_start : m.q_end],
                          t if m.strand else reverse_complement(t)))
    M, N = int(coords.q_len.max()), int(coords.t_len.max())
    row = compare_gather(card, "phase7", coords, M, N, pairs)
    if (M, N) != (packed[0].shape[1], packed[2].shape[1]) or row["P"] != stats["problems"]:
        raise AssertionError("the gather's batch is not the one map_all refined")
    slice_rows["refine_gather"] = row
    compare_gather(card, "synthetic_ecoli_size", *gather_scale_inputs(20_261_018))
    return (refine_launches, slice_rows, (unitigs, reads, cfg, index, names),
            [x.cpu() for x in packed])


def repeat_set():
    """Unitigs sharing one repeat in 8 copies (index entries 5..16: tier 2)
    beside unique unitigs, and reads of both."""
    from muchsalsa_tpu_torch.pipeline.mapper_torch import SequenceStore
    from muchsalsa_tpu_torch.testing.simulate import add_noise, random_genome

    rng = np.random.default_rng(48)
    rep = random_genome(rng, 300)
    unitigs, reads = SequenceStore(), SequenceStore()
    for i in range(40):
        g = random_genome(rng, 3_000)
        if i % 5 == 0:
            g = g[:500] + rep + g[500:]
        unitigs.add(f"u{i}", g)
        reads.add(f"r{i}", add_noise(rng, g[200:2_800], 0.05))
    for i in range(8):
        reads.add(f"rep{i}", add_noise(rng, rep, 0.05))
    return unitigs, reads


def time_stages(reads, index, cfg, device) -> tuple[int, dict]:
    """Median CUDA-event ms of each of the six mapping stages on one full
    batch (256 reads) of the bucket holding the most reads."""
    from muchsalsa_tpu_torch.ops import mapping_torch as mpt
    from muchsalsa_tpu_torch.ops.minimizer_torch import minimizer_sketch
    from muchsalsa_tpu_torch.pipeline.mapper_torch import (
        device_bucket_budgets, device_bucket_len)

    by_bucket: dict[int, list[bytes]] = {}
    for _rid, seq in reads.items():
        by_bucket.setdefault(device_bucket_len(len(seq)), []).append(seq)
    L, seqs = max(by_bucket.items(), key=lambda kv: len(kv[1]))
    seqs = seqs[:256]
    lut = np.full(256, 4, dtype=np.uint8)
    lut[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4, dtype=np.uint8)
    codes = np.full((256, L), 4, dtype=np.uint8)
    lens = np.zeros(256, dtype=np.int32)
    for i, seq in enumerate(seqs):
        codes[i, : len(seq)] = lut[np.frombuffer(seq, dtype=np.uint8)]
        lens[i] = len(seq)
    tables, takes = mpt.build_device_tables(
        index.hashes, index.offsets, index.entry_unitig, index.entry_pos, index.entry_strand,
        device=device)
    sel_L, pos_L, trim_L = device_bucket_budgets(L, cfg.k, 2048, 4)
    packed = (*mpt.pack_codes(codes, device=device), torch.from_numpy(lens).to(device))
    tail_kw = dict(k=cfg.k, bandwidth=cfg.bandwidth, min_anchor_count=cfg.min_anchor_count,
                   min_chain_score=cfg.min_chain_score, max_hits=64, trim=trim_L,
                   budget=16 * 256)

    def sketch():
        return minimizer_sketch(mpt.unpack_codes(*packed[:2]), packed[2], cfg.k, cfg.w)

    sk = sketch()
    sel = mpt.select_compact_device_v2(*sk, max_sel=sel_L)
    probe = mpt.probe_candidates_device_v2(*sel[:2], tables.rp)
    comp = mpt.compact_candidates_device_v2(*sel[:2], *probe, sel[2], max_pos=pos_L)
    anchors = mpt.expand_anchors_device_v2(*comp, tables.jrows, tables.erows, max_per_hit=4,
                                           hash_takes=takes)
    stages = {
        "sketch": sketch,
        "select": lambda: mpt.select_compact_device_v2(*sk, max_sel=sel_L),
        "probe": lambda: mpt.probe_candidates_device_v2(*sel[:2], tables.rp),
        "compact": lambda: mpt.compact_candidates_device_v2(*sel[:2], *probe, sel[2],
                                                           max_pos=pos_L),
        "expand": lambda: mpt.expand_anchors_device_v2(
            *comp, tables.jrows, tables.erows, max_per_hit=4, hash_takes=takes),
        "tail": lambda: mpt.anchors_to_hits_device_dense(*anchors, **tail_kw),
    }
    return L, {name: median_ms(fn, reps=10) for name, fn in stages.items()}


def phase_device_map(card: str, data, device) -> tuple[list[str], dict, dict]:
    """Phase 8: the port's map_all(device=True) on the card against its host
    map_all, with refinement off and on; a second call served by the batch
    cache; a repeat-rich set through tier 2; the six stages timed.  Returns
    the host mapping's PAF lines, the cached call's ``DEVICE_MAP_STATS`` and
    the walls of the host and device calls."""
    from muchsalsa_tpu_torch.device import resolve_device
    from muchsalsa_tpu_torch.ops.myers_torch import myers_edit_distance
    from muchsalsa_tpu_torch.pipeline import mapper_torch as mt

    unitigs, reads, cfg, index, names = data
    plain = dataclasses.replace(cfg, refine=False)
    t0 = time.perf_counter()
    host = mt.map_all(index, reads, plain, device=False, **names)
    host_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    walls = {}
    for call in ("cold", "cached"):
        t0 = time.perf_counter()
        got = mt.map_all(index, reads, plain, device=True, torch_device=device, **names)
        walls[call] = time.perf_counter() - t0
        if got != host:
            raise AssertionError(f"device mapping ({call}) differs from host mapping: "
                                 f"{len(got)} against {len(host)} lines")
        if not mt.DEVICE_MAP_STATS["v2"]:
            raise AssertionError("the index broke the v2 packing bounds")
        stats = dict(mt.DEVICE_MAP_STATS)
        emit("device_map", card=card, call=call, wall_s=walls[call], host_wall_s=host_s,
             lines=len(got), stats=stats)
    cache = getattr(reads, mt._CACHE_ATTR)[str(resolve_device(device))][1]
    if not cache:
        raise AssertionError("device mapping cached no read batch")
    peak = torch.cuda.max_memory_allocated()

    refine = dataclasses.replace(cfg, refine=True)
    myers_edit_distance.launches = 0
    t0 = time.perf_counter()
    refined_dev = mt.map_all(index, reads, refine, unitigs=unitigs, device=True,
                             torch_device=device, **names)
    refined_dev_s = time.perf_counter() - t0
    launches = myers_edit_distance.launches
    t0 = time.perf_counter()
    refined_host = mt.map_all(index, reads, refine, unitigs=unitigs, device=False,
                              torch_device=device, **names)
    refined_host_s = time.perf_counter() - t0
    if refined_dev != refined_host or launches == 0:
        raise AssertionError(f"refined device mapping differs from refined host mapping "
                             f"(exact Myers launches {launches})")

    rep_unitigs, rep_reads = repeat_set()
    rep_index = mt.MinimizerIndex.build(rep_unitigs, plain)
    want = mt.map_all(rep_index, rep_reads, plain, device=False)
    got = mt.map_all(rep_index, rep_reads, plain, device=True, torch_device=device)
    rep_stats = dict(mt.DEVICE_MAP_STATS)
    if got != want or rep_stats["tier2_reads"] == 0:
        raise AssertionError(f"repeat set: identical={got == want}, stats {rep_stats}")

    bucket, stage_ms = time_stages(reads, index, cfg, device)
    emit("device_map", card=card, refined_wall_s=refined_dev_s,
         refined_host_wall_s=refined_host_s, myers_full_launches=launches,
         cached_batches=len(cache), cuda_peak_bytes=peak, repeat_set_stats=rep_stats,
         repeat_set_lines=len(got), stage_bucket=bucket, stage_ms=stage_ms,
         identical=True)
    return host, stats, {"host_s": host_s, **walls}


JOIN_V1_GENOME = 140_000_000  # the JAX package's 140 Mb tier: v2 tables refused
JOIN_V1_UNITIG = 1_000
JOIN_V1_READS = 2_048          # 8 full batches of 256 in the 10,240 bucket
JOIN_V1_READ_LENGTH = 9_000


def join_v1_data(genome_length: int, n_reads: int, seed: int = 20260819):
    """A random genome cut into contiguous 1 kb unitigs (the genome of
    scripts/v2_refusal_sizes.py at the same size), and ``n_reads`` 9 kb
    reads from random positions on both strands with 8 % noise."""
    from muchsalsa_tpu_torch.pipeline.mapper_torch import SequenceStore
    from muchsalsa_tpu_torch.testing.simulate import add_noise, random_genome
    from muchsalsa_tpu_torch.utils.seq import reverse_complement

    rng = np.random.default_rng(seed)
    genome = random_genome(rng, genome_length)
    unitigs, reads = SequenceStore(), SequenceStore()
    for i, s in enumerate(range(0, genome_length - JOIN_V1_UNITIG + 1, JOIN_V1_UNITIG)):
        unitigs.add(f"u{i}", genome[s : s + JOIN_V1_UNITIG])
    starts = rng.integers(0, genome_length - JOIN_V1_READ_LENGTH, n_reads)
    forward = rng.integers(0, 2, n_reads).astype(bool)
    for i, (s, fwd) in enumerate(zip(starts.tolist(), forward.tolist())):
        read = genome[s : s + JOIN_V1_READ_LENGTH]
        reads.add(f"r{i}", add_noise(rng, read if fwd else reverse_complement(read), 0.08))
    return unitigs, reads


def time_v1_parts(reads, index, cfg, device) -> dict:
    """Median CUDA-event ms of the v1 join's parts on one full batch (the
    first 256 reads, in their length bucket): the sketch, the bitmap probe
    with the candidate compaction, the search with the expansion, the
    tail."""
    from muchsalsa_tpu_torch.ops import mapping_torch as mpt
    from muchsalsa_tpu_torch.ops.minimizer_torch import minimizer_sketch
    from muchsalsa_tpu_torch.pipeline.mapper_torch import (
        device_bucket_budgets, device_bucket_len)
    from muchsalsa_tpu_torch.utils.seq import encode_2bit

    seqs = [seq for _rid, seq in reads.items()][:256]
    L = device_bucket_len(max(len(s) for s in seqs))
    codes = np.full((256, L), 4, dtype=np.uint8)
    lens = np.zeros(256, dtype=np.int32)
    for i, seq in enumerate(seqs):
        codes[i, : len(seq)] = encode_2bit(seq)
        lens[i] = len(seq)
    codes, lens = torch.from_numpy(codes).to(device), torch.from_numpy(lens).to(device)
    _sel, pos_L, trim_L = device_bucket_budgets(L, cfg.k, 2048, 4)
    bitmap, _rank, _rounds = mpt.build_join_tables(index.hashes, device=device)
    arrays = (mpt.u32_tensor(index.hashes, device),
              torch.from_numpy(index.offsets.astype(np.int32)).to(device),
              *(torch.from_numpy(a).to(device)
                for a in (index.entry_unitig, index.entry_pos, index.entry_strand)))
    sk = minimizer_sketch(codes, lens, cfg.k, cfg.w)
    cands = mpt.v1_candidates(*sk, arrays[0], bitmap, pos_L)
    anchors = mpt.v1_expand(*cands, *arrays, pos_L, 4)
    tail = dict(k=cfg.k, bandwidth=cfg.bandwidth, min_anchor_count=cfg.min_anchor_count,
                min_chain_score=cfg.min_chain_score, max_hits=64)
    parts = {
        "sketch": lambda: minimizer_sketch(codes, lens, cfg.k, cfg.w),
        "probe_compact": lambda: mpt.v1_candidates(*sk, arrays[0], bitmap, pos_L),
        "search_expand": lambda: mpt.v1_expand(*cands, *arrays, pos_L, 4),
        "tail": lambda: mpt._anchors_to_hits(*anchors[:4], overflow=anchors[4], trim=trim_L,
                                             **tail),
    }
    return {"bucket": L, "max_pos": pos_L, "trim": trim_L,
            "n_cand_mean": float(cands[4].double().mean()),
            "ms": {name: median_ms(fn, reps=10) for name, fn in parts.items()}}


def phase_join_v1(card: str, device, genome_length: int = JOIN_V1_GENOME,
                  n_reads: int = JOIN_V1_READS, expect_refusal: bool = True) -> int:
    """Phase 10: an index that the v2 tables refuse (a 140 Mb random genome
    in 1 kb unitigs) mapped through the port's map_all on the card by the
    v1 join, identical to host mapping with refinement off and on (both
    refining on the card), fewer reads on the host than in all; the index
    and join-table builds, the bytes on the card, peak CUDA memory and the
    v1 join's parts timed on one full batch.  Returns the exact Myers
    kernel's launches of the refined device run."""
    from muchsalsa_tpu_torch.config import Config
    from muchsalsa_tpu_torch.ops import mapping_torch as mpt
    from muchsalsa_tpu_torch.ops.myers_torch import myers_edit_distance
    from muchsalsa_tpu_torch.pipeline import mapper_torch as mt

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    unitigs, reads = join_v1_data(genome_length, n_reads)
    data_s = time.perf_counter() - t0
    cfg = Config().mapper
    t0 = time.perf_counter()
    index = mt.MinimizerIndex.build(unitigs, cfg)
    index_s = time.perf_counter() - t0
    H, E = len(index.hashes), int(index.offsets[-1])
    bcnt = np.bincount(index.hashes >> np.uint32(32 - mpt.RANK2_LOG2),
                       minlength=1 << mpt.RANK2_LOG2)
    t0 = time.perf_counter()
    refused = mpt.build_device_tables(index.hashes, index.offsets, index.entry_unitig,
                                      index.entry_pos, index.entry_strand, device=device) is None
    refuse_s = time.perf_counter() - t0
    if expect_refusal and not refused:
        raise AssertionError(f"the v2 tables took the {genome_length} b index (H={H})")
    t0 = time.perf_counter()
    bitmap, rank, rounds = mpt.build_join_tables(index.hashes, device=device)
    if on_card:
        torch.cuda.synchronize()
    join_tables_s = time.perf_counter() - t0
    del bitmap, rank
    device_bytes = {"hashes": 8 * H, "offsets": 4 * (H + 1), "entries": 9 * E,
                    "bitmap": 4 << (mpt.BITMAP_LOG2_BITS - 5),
                    "rank": 4 * ((1 << mpt.RANK_LOG2) + 1)}
    names = dict(unitig_names=lambda u: unitigs.registry.name(u),
                 read_names=lambda r: reads.registry.name(r))

    t0 = time.perf_counter()
    got = mt.map_all(index, reads, cfg, device=True, torch_device=device, **names)
    device_s = time.perf_counter() - t0
    stats = dict(mt.DEVICE_MAP_STATS)
    t0 = time.perf_counter()
    want = mt.map_all(index, reads, cfg, device=False, **names)
    host_s = time.perf_counter() - t0
    if got != want:
        raise AssertionError(f"v1 device mapping differs from host mapping: {len(got)} "
                             f"against {len(want)} lines")
    if stats["v2"] is not False or not stats["overflow_reads"] < stats["total_reads"] == n_reads:
        raise AssertionError(f"the reads were not mapped by the v1 join: {stats}")

    refine = dataclasses.replace(cfg, refine=True)
    myers_edit_distance.launches = 0
    t0 = time.perf_counter()
    refined_dev = mt.map_all(index, reads, refine, unitigs=unitigs, device=True,
                             torch_device=device, **names)
    refined_device_s = time.perf_counter() - t0
    launches = myers_edit_distance.launches
    refined_stats = dict(mt.DEVICE_MAP_STATS)
    t0 = time.perf_counter()
    refined_host = mt.map_all(index, reads, refine, unitigs=unitigs, device=False,
                              torch_device=device, **names)
    refined_host_s = time.perf_counter() - t0
    if refined_dev != refined_host or refined_stats["v2"] is not False:
        raise AssertionError(f"refined v1 device mapping differs from refined host mapping "
                             f"({len(refined_dev)} against {len(refined_host)} lines)")
    if on_card and launches == 0:
        raise AssertionError("the refined v1 run never launched the exact Myers kernel")
    assert_no_reference("the port's v1 join")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    parts = time_v1_parts(reads, index, cfg, device) if on_card else "not measured"
    emit("join_v1", card=card, genome_bases=genome_length, unitigs=len(unitigs.ids()),
         reads=n_reads, read_length=JOIN_V1_READ_LENGTH, hashes=H, entries=E,
         largest_probe_bucket=int(bcnt.max()), probe_buckets_over_31=int((bcnt > 31).sum()),
         v2_refused=refused, data_s=data_s, index_s=index_s, refuse_s=refuse_s,
         join_tables_s=join_tables_s, join_rounds=rounds, device_bytes=device_bytes,
         device_bytes_total=sum(device_bytes.values()), device_wall_s=device_s,
         host_wall_s=host_s, lines=len(got), stats=stats,
         overflow_share=stats["overflow_reads"] / stats["total_reads"],
         refined_device_wall_s=refined_device_s, refined_host_wall_s=refined_host_s,
         myers_full_launches=launches, cuda_peak_bytes=peak, parts=parts, identical=True)
    return launches


def write_fasta(path: Path, records) -> None:
    with open(path, "wb") as fh:
        for name, seq in records:
            fh.write(b">" + name.encode() + b"\n" + seq + b"\n")


FULL_LEGS = ("device_map", "device_kmer", "device_dbg", "device_scrub")
FULL_FILES = ("01_illu_filtered.fa", "01_unitigs.fa", "01_unitigs.paf",
              "01_contigs_corrected.paf", "02_scrubbed.fa",
              "02_contigs_corrected.scrubbed.paf", "03.assembly.unpolished.fa")


def phase_full(card: str, work: Path, sim, reads, device) -> tuple[int, int]:
    """Phase 9: raw reads -> assembly through the port's run_full_pipeline
    with every device leg on the card (mapping, k-mer counting, the DBG
    extension table, the scrub's all-vs-all), against the same pipeline
    with all four on the host; refinement and the core's chaining on the
    card in both.  Each leg must have run on the card and the scrub's guard
    must have declined no subset.  Returns the chain_dp and myers_full launches of
    the device run."""
    from muchsalsa_tpu_torch.config import Config
    from muchsalsa_tpu_torch.device import resolve_device
    from muchsalsa_tpu_torch.ops.chain_scan import chain_dp
    from muchsalsa_tpu_torch.ops.dbg_torch import DBG_DEVICE_STATS
    from muchsalsa_tpu_torch.ops.kmer_torch import KMER_DEVICE_STATS
    from muchsalsa_tpu_torch.ops.myers_torch import myers_edit_distance
    from muchsalsa_tpu_torch.pipeline.full import run_full_pipeline
    from muchsalsa_tpu_torch.pipeline.scrubber import SCRUB_DEVICE_STATS
    from muchsalsa_tpu_torch.testing.simulate import illumina_pairs

    t0 = time.perf_counter()
    data = work / "full_data"
    data.mkdir(parents=True)
    nano = data / "nanopore.fa"
    write_fasta(nano, ((reads.registry.name(rid), seq) for rid, seq in reads.items()))
    pairs = illumina_pairs(np.random.default_rng(2), sim.genome, coverage=25.0)
    illu1, illu2 = data / "illu_1.fa", data / "illu_2.fa"
    write_fasta(illu1, ((f"p{i}/1", a) for i, (a, b) in enumerate(pairs)))
    write_fasta(illu2, ((f"p{i}/2", b) for i, (a, b) in enumerate(pairs)))
    data_s = time.perf_counter() - t0
    cfg = Config()
    cfg = dataclasses.replace(cfg, mapper=dataclasses.replace(cfg.mapper, refine=True))

    runs = {}
    for name, on in (("device", True), ("host", False)):
        out = work / f"full_{name}"
        torch.cuda.reset_peak_memory_stats()
        for stats in (KMER_DEVICE_STATS, DBG_DEVICE_STATS, SCRUB_DEVICE_STATS):
            stats.clear()
        chain_dp.launches = 0
        myers_edit_distance.launches = 0
        t0 = time.perf_counter()
        run_full_pipeline(illu1, illu2, nano, out, cfg, device=device,
                          **{leg: on for leg in FULL_LEGS})
        wall = time.perf_counter() - t0
        assert_no_reference("the port's full pipeline")
        manifest = json.loads((out / "manifest.json").read_text())
        runs[name] = {
            "out": out, "wall_s": wall, "cuda_peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": {"chain_dp": chain_dp.launches,
                         "myers_full": myers_edit_distance.launches},
            "stages_s": {k: v["elapsed_s"] for k, v in manifest.items()},
            "report": [ln for ln in (out / "report.txt").read_text().splitlines()
                       if ln.startswith("device ")],
            "legs": {"kmer": dict(KMER_DEVICE_STATS), "dbg": dict(DBG_DEVICE_STATS),
                     "scrub": dict(SCRUB_DEVICE_STATS)},
        }
    dev, host = runs["device"], runs["host"]
    identical = {n: (dev["out"] / n).read_bytes() == (host["out"] / n).read_bytes()
                 for n in FULL_FILES}
    final = (dev["out"] / FULL_FILES[-1]).read_bytes()
    contigs = final.count(b">")
    legs = dev["legs"]
    emit("full", card=card, genome_mb=len(sim.genome) / 1e6, illumina_pairs=len(pairs),
         nanopore_reads=len(reads), data_s=data_s, contigs=contigs,
         assembly_bases=len(final) - final.count(b"\n") - sum(
             len(ln) for ln in final.split(b"\n") if ln.startswith(b">")),
         identical=identical,
         # the device legs' stage walls beside the host's: [device run, host run]
         leg_walls_s={st: [dev["stages_s"][st], host["stages_s"][st]]
                      for st in ("kmer_filter", "unitigs", "scrub")},
         scrub_subsets=legs["scrub"].get("subsets"),
         **{f"{k}_{f}": v[f] for k, v in runs.items()
            for f in ("wall_s", "cuda_peak_bytes", "launches", "stages_s", "report", "legs")})
    if not all(identical.values()):
        raise AssertionError(f"full with the device legs differs from the host run: {identical}")
    if contigs < 1:
        raise AssertionError("the full pipeline assembled no contig")
    if min(dev["launches"].values()) == 0:
        raise AssertionError(f"the full pipeline's kernels did not launch: {dev['launches']}")
    on_card = str(resolve_device(device))
    if not (legs["kmer"].get("device") == on_card and legs["kmer"]["chunks"] > 0):
        raise AssertionError(f"the k-mer leg counted no chunk on {on_card}: {legs['kmer']}")
    if not (legs["dbg"].get("device") == on_card and legs["dbg"]["rows"] > 0):
        raise AssertionError(f"the DBG leg built no extension row on {on_card}: {legs['dbg']}")
    scrub = legs["scrub"]
    if not (scrub.get("device") == on_card and scrub["on_device"] >= 1
            and scrub["declined"] == 0):
        raise AssertionError(f"the scrub's all-vs-all did not run on {on_card}: {scrub}")
    if any(runs["host"]["legs"].values()):
        raise AssertionError(f"the host run reached a device leg: {runs['host']['legs']}")
    return dev["launches"]["chain_dp"], dev["launches"]["myers_full"]


SCALE_MB = 1.0  # phase 12's row of testing/scale.py::SCALE_ROWS


def phase_scale(card: str, work: Path, device, v1: bool = False) -> None:
    """Phase 12: the ``SCALE_MB`` row of ``SCALE_ROWS`` through the port's
    ``full`` with every leg on the card, held to the JAX package's hashes
    and contig statistics.  With ``v1`` the map stages' ``build_device_tables``
    refuses, as it does for every genome from ~60 Mb up, so each map stage
    takes the v1 join."""
    from muchsalsa_tpu_torch.pipeline import mapper_torch
    from muchsalsa_tpu_torch.testing.scale import run_scale_row

    t0 = time.perf_counter()
    build_tables = mapper_torch.build_device_tables
    if v1:
        mapper_torch.build_device_tables = lambda *a, **k: None
    try:
        record = run_scale_row(work / ("scale_v1" if v1 else "scale"), SCALE_MB, device=device,
                               log=lambda line: None, config=with_device_config(**GATES_OPEN))
    finally:
        mapper_torch.build_device_tables = build_tables
    assert_no_reference("the port's scale row")
    emit("scale_v1" if v1 else "scale", card=card, phase_s=time.perf_counter() - t0,
         **{k: record[k] for k in (
             "genome_mb", "simulation_s", "full_s", "stages_s", "stats", "equal",
             "cuda_peak_bytes", "core_cuda_peak_bytes", "kmer", "dbg", "map", "chain",
             "chain_dp_launches")},
         scrub={k: v for k, v in record["scrub"].items() if k != "subsets"},
         scrub_subsets=[(s["multiplicity"], s["chunks"], s["declined"])
                        for s in record["scrub"].get("subsets", [])])
    if not (record["row"] and record["equal"] and all(record["equal"].values())):
        raise AssertionError(f"the {SCALE_MB} Mb scale row differs from the JAX package's: "
                             f"{record['equal']}, {record['sha256']}")
    if record["chain_dp_launches"] == 0:
        raise AssertionError("the scale row's core never launched chain_dp")
    v2 = {name: st["v2"] for name, st in record["map"].items()}
    if len(v2) != 3 or any(x == v1 for x in v2.values()):
        raise AssertionError(f"the scale row's map stages did not all take the "
                             f"{'v1 join' if v1 else 'v2 tables'}: {v2}")
    on_card = str(torch.device("cuda", torch.cuda.current_device()))
    if record["kmer"].get("device") != on_card or record["dbg"].get("device") != on_card:
        raise AssertionError(f"the scale row's legs did not run on {on_card}: "
                             f"{record['kmer']}, {record['dbg']}")


def run_group(script: str, n: int, args_of, timeout: float) -> float:
    """``n`` processes of ``scripts/{script}`` in one gloo process group on
    the card (``--device cuda``); ``args_of(pid)`` gives a process's
    arguments after the coordinator.  Returns the wall until the last one
    exited; raises unless each exits 0, and kills any left at the end."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(root / "scripts" / script), str(pid), str(n), coordinator,
         *map(str, args_of(pid)), "--device", "cuda"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(n)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    for pid, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{script} process {pid} exited {p.returncode}:\n{so}\n"
                                 f"{se[-3000:]}")
    return wall


def phase_multi(card: str, work: Path, core_args, core_wall: float, dp_batch, regions,
                mapping) -> None:
    """Phase 11: two shards, then two processes, on the one card.

    a. ``visible_devices`` lists cuda:0 twice: ``sharded_chain_dp`` on phase
       4's largest packed batch and ``sharded_myers`` on phase 7's regions
       (one empty problem appended where P is odd) against one launch of
       each kernel; phase 4's core and phase 8's device mapping through the
       port's entry points with that mesh.
    b. ``scripts/torch_distributed_core.py`` and ``torch_distributed_scrub.py``
       in two processes of a gloo group on the card, against phase 4's port
       run and an in-process ``scrub_reads`` on the card of phase 8's reads
       and mapping (subsets of 2,000 reads, at least one on the card).
    Walls stand beside their unsharded or single-process counterparts; they
    are two shards or two processes sharing one card, not a scaling
    measurement."""
    from muchsalsa_tpu_torch.assemble.driver import assemble
    from muchsalsa_tpu_torch.config import MapperConfig, ScrubConfig
    from muchsalsa_tpu_torch.io.fasta import SequenceStore
    from muchsalsa_tpu_torch.io.fasta import write_fasta as port_write_fasta
    from muchsalsa_tpu_torch.ops.chain_scan import chain_dp
    from muchsalsa_tpu_torch.ops.myers_torch import myers_edit_distance
    from muchsalsa_tpu_torch.parallel import mesh as mesh_mod
    from muchsalsa_tpu_torch.parallel.sharded import sharded_chain_dp, sharded_myers
    from muchsalsa_tpu_torch.pipeline import mapper_torch as mt
    from muchsalsa_tpu_torch.pipeline.scrubber import SCRUB_DEVICE_STATS, scrub_reads

    cuda0 = torch.device("cuda", 0)
    two = mesh_mod.make_mesh(devices=[cuda0, cuda0])
    gates_open = with_device_config(**GATES_OPEN)
    gates_json = work / "gates_open.json"
    gates_open.save(gates_json)
    row: dict = {"card": card, "label": "2 shards / 2 processes on one card"}

    # a. the chaining kernel, two shards against one launch
    packed, K, wiggle_room = dp_batch
    on_card = [x.cuda() for x in packed]
    ref_s, ref_b = chain_dp(*on_card, K, wiggle_room)
    before = chain_dp.launches
    s, b, stats = sharded_chain_dp(*packed, K, wiggle_room, two)
    torch.cuda.synchronize()
    launched = chain_dp.launches - before
    sizes = (packed[2][1:] - packed[2][:-1]).long()
    best = torch.where(torch.arange(K) < sizes[:, None], ref_s.cpu(), 0.0).amax(1)
    host_stats = [float((sizes > 0).sum()), float(best.sum())]
    if not (torch.equal(s, ref_s) and torch.equal(b, ref_b)) or launched != 2:
        raise AssertionError(f"sharded_chain_dp: equal={torch.equal(s, ref_s)}, "
                             f"{torch.equal(b, ref_b)}, launches {launched}")
    if float(stats[0]) != host_stats[0] or abs(float(stats[1]) - host_stats[1]) > (
            1e-12 * abs(host_stats[1])):
        raise AssertionError(f"sharded_chain_dp stats {stats.tolist()}, host sum {host_stats}")
    row["chain_dp"] = {
        "B": sizes.numel(), "K": K, "N": packed[0].shape[1], "launches": launched,
        "stats": stats.tolist(), "host_stats": host_stats,
        "sharded_ms": median_ms(lambda: sharded_chain_dp(*on_card, K, wiggle_room, two), 10),
        "unsharded_ms": median_ms(lambda: chain_dp(*on_card, K, wiggle_room), 10)}
    del on_card, ref_s, ref_b, s, b

    # a. the exact Myers kernel, two shards against one launch
    P = regions[0].shape[0]
    pad = (-P) % two.size
    q, ql, t, tl = regions
    args = [torch.cat([x, torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype)]).cuda()
            for x, fill in ((q, 5), (ql, 0), (t, 4), (tl, 0))]
    ref_d = myers_edit_distance(*args)
    before = myers_edit_distance.launches
    d, total = sharded_myers(*args, two)
    torch.cuda.synchronize()
    launched = myers_edit_distance.launches - before
    exact = int(ref_d.long().sum())
    # the total is float32, as the JAX step's psum: exact to 2^24, then rounded
    if not torch.equal(d, ref_d) or launched != 2 or abs(float(total) - exact) > 1e-6 * exact:
        raise AssertionError(f"sharded_myers: equal={torch.equal(d, ref_d)}, launches "
                             f"{launched}, total {float(total)} against {exact}")
    row["myers_full"] = {
        "P": P, "padded_P": P + pad, "launches": launched, "total": float(total),
        "exact_total": exact,
        "sharded_ms": median_ms(lambda: sharded_myers(*args, two), 10),
        "unsharded_ms": median_ms(lambda: myers_edit_distance(*args), 10)}
    del args, ref_d, d

    # a. the core and device mapping through the port's entry points
    out2 = work / "ecoli" / "mesh2"
    unitigs, reads, cfg, index, names, host_lines, map_stats, map_walls = mapping
    plain = dataclasses.replace(cfg, refine=False)
    saved = mesh_mod.visible_devices
    mesh_mod.visible_devices = lambda: [cuda0, cuda0]
    try:
        chain_dp.launches = 0
        t0 = time.perf_counter()
        meshed = assemble(*core_args, out2, gates_open, device="cuda")
        meshed_wall = time.perf_counter() - t0
        core_launches = chain_dp.launches
        t0 = time.perf_counter()
        mapped = mt.map_all(index, reads, plain, device=True, torch_device="cuda", **names)
        map_wall = time.perf_counter() - t0
        stats2 = dict(mt.DEVICE_MAP_STATS)
    finally:
        mesh_mod.visible_devices = saved
    assert_no_reference("the port's meshed core and mapping")
    port_out = work / "ecoli" / "port"
    same = {n: (out2 / n).read_bytes() == (port_out / n).read_bytes() for n in OUTPUTS}
    counters = meshed["timer"].counters
    buckets = sum(1 for k in counters if k.startswith("chain_batch_k"))
    if not all(same.values()) or counters["mesh_devices"] != 2 or (
            core_launches != 2 * buckets or buckets == 0):
        raise AssertionError(f"the 2-shard core: identical {same}, mesh_devices "
                             f"{counters['mesh_devices']}, chain_dp launches {core_launches} "
                             f"over {buckets} buckets")
    if mapped != host_lines or not (stats2["meshed"] and stats2["n_devices"] == 2
                                    and stats2["tier2_reads"] == 0 and stats2["v2"]):
        raise AssertionError(f"the 2-shard mapping: identical {mapped == host_lines}, {stats2}")
    row["core"] = {"wall_s": meshed_wall, "unsharded_wall_s": core_wall, "identical": same,
                   "mesh_devices": counters["mesh_devices"], "chain_dp_launches": core_launches,
                   "chain_batches": {k: v for k, v in counters.items()
                                     if k.startswith("chain_batch_k")}}
    row["device_map"] = {
        "wall_s": map_wall, "unsharded_wall_s": map_walls["cached"],
        "host_wall_s": map_walls["host_s"], "lines": len(mapped), "stats": stats2,
        "overflow_share": stats2["overflow_reads"] / stats2["total_reads"],
        "unsharded_overflow_share": map_stats["overflow_reads"] / map_stats["total_reads"]}

    # b. the core in two processes
    paf, unitigs_fa, reads_fa = core_args
    procs_wall = run_group("torch_distributed_core.py", 2,
                           lambda pid: (paf, unitigs_fa, reads_fa, work / "ecoli" / f"proc{pid}",
                                        "--config", gates_json),
                           timeout=300)
    same = {f"p{pid}/{n}": (work / "ecoli" / f"proc{pid}" / n).read_bytes()
            == (port_out / n).read_bytes() for pid in range(2) for n in OUTPUTS}
    if not all(same.values()):
        raise AssertionError(f"the 2-process core differs from phase 4's port run: {same}")
    row["core_2_processes"] = {"wall_s": procs_wall, "single_process_wall_s": core_wall,
                               "identical": same}

    # b. the scrub in two processes, against one in-process scrub on the card,
    # of what `full` scrubs: the long reads and their mapping (phase 8's);
    # the guard declines every subset of phase 4's own PAF (multiplicity ~15)
    scrub_reads_fa, scrub_paf = work / "scrub_reads.fa", work / "scrub.paf"
    port_write_fasta(scrub_reads_fa, ((names["read_names"](rid), seq)
                                      for rid, seq in reads.items()))
    scrub_paf.write_text("\n".join(host_lines) + "\n")
    store = SequenceStore()
    store.load(scrub_reads_fa)
    scfg = ScrubConfig(subset_size=2_000)
    t0 = time.perf_counter()
    single = scrub_reads(host_lines, store, scfg, MapperConfig(), device="cuda")
    scrub_wall = time.perf_counter() - t0
    scrub_stats = dict(SCRUB_DEVICE_STATS)
    expected, got = work / "scrub_single.fa", work / "scrub_2p.fa"
    port_write_fasta(expected, single)
    procs_wall = run_group("torch_distributed_scrub.py", 2,
                           lambda pid: (scrub_reads_fa, scrub_paf, got, scfg.subset_size),
                           timeout=300)
    if got.read_bytes() != expected.read_bytes() or len(scrub_stats["subsets"]) < 2 or (
            scrub_stats["on_device"] == 0):
        raise AssertionError(f"the 2-process scrub: identical "
                             f"{got.read_bytes() == expected.read_bytes()}, "
                             f"{len(scrub_stats['subsets'])} subsets, "
                             f"{scrub_stats['on_device']} on the card")
    row["scrub_2_processes"] = {
        "wall_s": procs_wall, "single_process_wall_s": scrub_wall, "records": len(single),
        "subset_size": scfg.subset_size, "subsets": len(scrub_stats["subsets"]),
        "subsets_on_card": scrub_stats["on_device"], "declined": scrub_stats["declined"],
        "identical": True}
    emit("multi", **row)


def with_device_config(**device_fields):
    from muchsalsa_tpu_torch.config import Config

    cfg = Config()
    return dataclasses.replace(cfg, device=dataclasses.replace(cfg.device, **device_fields))


def main() -> int:
    # --- 0. setup
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(card, flush=True)
    emit("setup", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), python=sys.version.split()[0])

    from muchsalsa_tpu_torch import kernels
    from muchsalsa_tpu_torch.assemble.driver import _on_device, assemble
    from muchsalsa_tpu_torch.config import Config
    from muchsalsa_tpu_torch.ops import chaining_torch
    from muchsalsa_tpu_torch.ops.chain_scan import chain_dp, chain_scan, compat_init_batch
    from muchsalsa_tpu_torch.state import pack_batch, unpack_batch
    from muchsalsa_tpu_torch.testing.chains import KINDS as CHAIN_KINDS
    from muchsalsa_tpu_torch.testing.chains import WIGGLE_ROOM, chain_batch, inverted_pair_batch

    # --- 1. build
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.load()
    emit("build", seconds=time.perf_counter() - t0, library=lib_path.name,
         # ptxas puts each function's stack and spill bytes on a line of their own
         ptxas=[ln.strip() for ln in kernels.build_log.splitlines()
                if "ptxas" in ln or "spill" in ln])
    sms, clock_mhz, int32_ops_per_s = card_int32_rate()
    emit("rates", card=card, sms=sms, clocks_max_sm_mhz=clock_mhz,
         int32_ops_per_s=int32_ops_per_s, hbm_bytes_per_s=HBM_BYTES_PER_S,
         fp64_flops=FP64_FLOPS)

    # --- 2. kernels vs plain versions at the bucket shapes
    scan_inputs = load_test_module("test_torch_kernels_cuda").scan_inputs
    max_err = {"chain_scan": 0.0, "chain_dp": 0.0}
    for B, K in PHASE2_SHAPES:
        for kind in ("random", "all_true", "all_false"):
            compat, init = scan_inputs(B, K, kind, B * 1000 + K)
            row = compare_scan(torch.from_numpy(compat).cuda(), torch.from_numpy(init).cuda(),
                               kind, timed=kind == "random")
            max_err["chain_scan"] = max(max_err["chain_scan"], row["max_abs_err"])
            emit("kernels", card=card, **row)
        for kind in CHAIN_KINDS:
            packed = [x.cuda() for x in pack_batch(chain_batch(B, K, kind, B * 1000 + K))]
            row = compare_dp(packed, K, WIGGLE_ROOM, kind, timed=kind == "random")
            max_err["chain_dp"] = max(max_err["chain_dp"], row["max_abs_err"])
            emit("kernels", card=card, **row)
    # the pair order: two anchors that only (anchor k, anchor l) leaves unchained
    packed = [x.cuda() for x in pack_batch(inverted_pair_batch())]
    row = compare_dp(packed, 8, WIGGLE_ROOM, "inverted_pair", timed=False)
    s, b = chain_dp(*packed, 8, WIGGLE_ROOM)
    if s[0, :2].tolist() != [500.0, 700.0] or b[0, :2].tolist() != [-1, -1]:
        raise AssertionError(f"chain_dp chained the inverted pair: {s[0, :2].tolist()}, "
                             f"{b[0, :2].tolist()}")
    emit("kernels", card=card, **row)
    del packed  # the last batch would count in phase 4's peak memory

    from muchsalsa_tpu_torch.testing.simulate import simulate, write_simulation

    GOLDEN = golden_hashes()

    # phase 11 reads phase 4's inputs and outputs: the directory lasts the run
    work = Path(tempfile.mkdtemp(prefix="ms_chip_smoke_"))
    atexit.register(shutil.rmtree, work, ignore_errors=True)

    # --- 3. golden, every bucket through the kernel
    sim = simulate(np.random.default_rng(20260817), genome_length=60_000,
                   unitig_length=1_100, unitig_gap=300, read_length=6_000,
                   coverage=9.0, both_strands=True)
    paths = write_simulation(sim, work / "golden" / "data")
    chain_dp.launches = 0
    assemble(paths["paf"], paths["unitigs"], paths["reads"], work / "golden" / "out",
             with_device_config(min_device_batch=1, **GATES_OPEN), device="cuda")
    golden_launches = chain_dp.launches
    got = {n: hashlib.sha256((work / "golden" / "out" / n).read_bytes()).hexdigest()
           for n in GOLDEN}
    if got != GOLDEN:
        raise AssertionError(f"golden mismatch on the card: {got}")
    if golden_launches == 0:
        raise AssertionError("golden run never launched chain_dp")
    emit("golden", match=True, chain_dp_launches=golden_launches)

    # --- 4. E. coli-scale core, port on the card vs the host oracle
    t0 = time.perf_counter()
    sim = simulate(np.random.default_rng(20260819), genome_length=4_600_000,
                   coverage=15.0, read_length=9_000, unitig_length=1_000,
                   unitig_gap=300)
    paths = write_simulation(sim, work / "ecoli" / "data")
    n_reads = sum(1 for _ in sim.read_records())
    sim_s = time.perf_counter() - t0
    args = (paths["paf"], paths["unitigs"], paths["reads"])

    # keep a host copy of every packed batch the core hands chain_dp
    core_batches = []

    def keep_batch(fields, flags, offsets, K, wiggle_room):
        core_batches.append(([x.cpu() for x in (fields, flags, offsets)], K, wiggle_room))
        return chain_dp(fields, flags, offsets, K, wiggle_room)

    chaining_torch.chain_dp = keep_batch
    chain_dp.launches = chain_scan.launches = 0
    t0 = time.perf_counter()
    port = assemble(*args, work / "ecoli" / "port", with_device_config(**GATES_OPEN),
                    device="cuda")
    port_wall = time.perf_counter() - t0
    chaining_torch.chain_dp = chain_dp
    core_launches = chain_dp.launches
    core_scan_launches = chain_scan.launches
    assert_no_reference("the port's assembly")
    if core_launches == 0 or not all(port["timer"].counters[k] for k in (
            "edges_on_device", "chaining_on_device")):
        raise AssertionError("the E. coli-scale core did not run on the card: "
                             f"{core_launches} chain_dp launches, {port['timer'].counters}")

    t0 = time.perf_counter()
    host = assemble(*args, work / "ecoli" / "host", with_device_config(use_device=False),
                    device="cuda")
    host_wall = time.perf_counter() - t0
    if (chain_dp.launches != core_launches or chain_scan.launches != core_scan_launches
            or host["timer"].counters["chaining_on_device"]):
        raise AssertionError("the host oracle's run reached the card")
    identical = {n: (work / "ecoli" / "port" / n).read_bytes()
                 == (work / "ecoli" / "host" / n).read_bytes() for n in OUTPUTS}
    counters = port["timer"].counters
    batches = {int(k.removeprefix("chain_batch_k")): v
               for k, v in counters.items() if k.startswith("chain_batch_k")}
    placement = {k: counters[k] for k in ("edges_on_device", "chaining_on_device")}
    dcfg = Config().device
    default_placement = {
        "edges_on_device": _on_device(Config(), counters["match_rows"],
                                      dcfg.edges_device_min_rows, torch.device("cuda")),
        "chaining_on_device": _on_device(Config(), 2 * counters["graph_size"],
                                         dcfg.chain_device_min_problems, torch.device("cuda"))}
    emit("core", card=card, genome_mb=4.6, coverage=15.0, reads=n_reads,
         **placement, match_rows=counters["match_rows"],
         two_graph_size=2 * counters["graph_size"], default_placement=default_placement,
         simulate_s=sim_s, port_wall_s=port_wall, host_wall_s=host_wall,
         port_stages=port["timer"].stages, host_stages=host["timer"].stages,
         chain_device_problems=counters["chain_device_problems"],
         chain_host_problems=counters["chain_host_problems"],
         chain_batches=batches, chain_dp_launches=core_launches,
         chain_scan_launches=core_scan_launches,
         cuda_peak_bytes=port["memory"]["device_peak_bytes_allocated"],
         components=port["components"], paths=port["paths"],
         identical=identical)
    if not all(identical.values()):
        raise AssertionError(f"port output differs from the host oracle: {identical}")
    if port["paths"] < 1 or not (work / "ecoli" / "port" / OUTPUTS[0]).stat().st_size:
        raise AssertionError("the E. coli-scale core assembled no contig")

    # --- 5. both chaining kernels vs their plain versions on the core's own batches
    main_rows = {"chain_dp": [], "chain_scan": []}
    if sorted((p[2].shape[0] - 1, K) for p, K, _ in core_batches) != sorted(
            (B, K) for K, B in batches.items()):
        raise AssertionError(f"kept batches differ from the core's {batches}")
    for packed, K, wiggle_room in core_batches:
        packed = [x.cuda() for x in packed]
        row = compare_dp(packed, K, wiggle_room, "core", timed=True)
        compat, init = compat_init_batch(unpack_batch(*packed, K), wiggle_room)
        rows = [row, compare_scan(compat, init, "core", timed=True)]
        del compat, init
        for row in rows:
            max_err[row["kernel"]] = max(max_err[row["kernel"]], row["max_abs_err"])
            main_rows[row["kernel"]].append(row)
            emit("shapes", card=card, **row)
    # phase 11 shards the largest batch over two shards
    dp_batch = max(core_batches, key=lambda b: b[0][2].shape[0])
    del core_batches

    # --- 6. edit-distance kernels vs their plain versions
    align_err = phase_align_kernels(card, torch.device("cuda"), int32_ops_per_s)

    # --- 7. refinement on the card, through the port's entry points
    refine_launches, slice_rows, map_data, regions = phase_refine(
        card, sim, torch.device("cuda"), align_err, int32_ops_per_s)

    # --- 8. device mapping on the card, through the port's map_all
    host_lines, map_stats, map_walls = phase_device_map(card, map_data, "cuda")

    # --- 9. raw reads -> assembly, mapping on the card
    with tempfile.TemporaryDirectory(prefix="ms_chip_smoke_full_") as td:
        phase_full(card, Path(td), sim, map_data[1], "cuda")
    del sim

    # --- 10. the v1 join on an index that the v2 tables refuse
    phase_join_v1(card, "cuda")

    # --- 11. two shards and two processes on the one card
    phase_multi(card, work, args, port_wall, dp_batch, regions,
                (*map_data, host_lines, map_stats, map_walls))
    del map_data

    # --- 12. the 1 Mb scale row, every leg on the card, then again with
    # every map stage on the v1 join
    phase_scale(card, work, "cuda")
    phase_scale(card, work, "cuda", v1=True)

    assert_no_reference("chip_smoke")
    # no single PyTorch call computes any of the six functions: no yardstick;
    # the chaining rows time the bucket that carried the most problems
    summary = []
    for name, launches, replaces in (
            ("chain_scan", core_scan_launches, "muchsalsa_tpu/ops/chaining_pallas.py:30"),
            ("chain_dp", core_launches, "muchsalsa_tpu/ops/chaining_pallas.py:74")):
        top = max(main_rows[name], key=lambda r: r["B"])
        summary.append({
            "name": name, "route": "cuda",
            "source": "muchsalsa_tpu_torch/csrc/chain_scan.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max_err[name],
            "ms": top["ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "library_ms": None,
        })
    for name, replaces in (("myers_full", "muchsalsa_tpu/ops/myers_full_pallas.py:42"),
                           ("myers_banded", "muchsalsa_tpu/ops/myers_pallas.py:61"),
                           ("banded_wavefront", "muchsalsa_tpu/ops/align_pallas.py:54")):
        summary.append({
            "name": name, "route": "cuda",
            "source": f"muchsalsa_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": refine_launches[name],
            "max_abs_err": align_err[name],
            "ms": slice_rows[name]["ms"],
            "plain_ms": slice_rows[name]["plain_ms"],
            "bound_ms": slice_rows[name]["bound_ms"],
            "bound_by": slice_rows[name]["bound_by"],
            "library_ms": None,
        })
    gather = slice_rows["refine_gather"]
    summary.append({
        "name": "refine_gather", "route": "cuda",
        "source": "muchsalsa_tpu_torch/csrc/refine_gather.cu",
        "replaces": None,  # the host's pack_problems; no TPU kernel
        "launches": refine_launches["refine_gather"],
        "max_abs_err": 0,
        "ms": gather["ms"],
        "plain_ms": gather["plain_ms"],
        "bound_ms": gather["bound_ms"],
        "bound_by": gather["bound_by"],
        "library_ms": None,
    })
    emit("done", card=card, seconds=time.perf_counter() - _T0)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
