#!/usr/bin/env python3
"""The crossovers of the core's placement gates and of ``min_device_batch``
on one GPU: the sizes from which the card beats the host oracle.

    PYTHONPATH=. python3 scripts/torch_gate_crossover.py \\
        [--sizes 0.05,0.1,0.25,0.5,1,2,4.6] [--device cuda|cpu] [--out build/gate_crossover]

1. ``build`` — the kernel library (nvcc) and the native host library, so
   that no later process builds either; a cold nvcc build is reported apart.
2. ``batch`` — ``min_device_batch``, a bucket at a time: for K in
   ``--ks`` and n in ``--ns`` problems of ``testing/chains.py``'s random
   kind, each holding as many anchors as a problem the driver bins into
   bucket K (more than the bucket below, at most K): drawn from the
   problems of the core at the largest ``--sizes`` where it has any in
   that bucket, else uniformly; over ``--seeds`` draws, the host oracle's
   DP of the n problems (``ops/chaining.py::max_pairwise_paths`` up to, not including,
   the ``finalize_paths`` both branches share: the branch that
   ``ops/chaining_torch.py`` takes for a bucket under ``min_device_batch``)
   against the device branch's own work (``bucket_batch`` into pinned
   memory, the copy, ``chain_dp``, the copy back and ``_reconstruct``);
   median ms of each, the DP scores of both equal.  A K's crossover is the
   smallest n from which the card's mean over the draws is no slower at
   that n and every larger one (each draw's own crossover is printed
   beside it); the suggested default is the largest over the K values.
3. ``probe`` — one fresh process on the smallest size with both gates
   closed: whether the card's primary context exists (the driver API's
   ``cuDevicePrimaryCtxGetState``) after importing the port, after
   ``resolve_device``, after ``torch.cuda.reset_peak_memory_stats``, after
   ``max_memory_allocated``, after the whole ``assemble``, and after a
   first tensor on the card, with each step's seconds.
4. ``size`` — for each genome size (Mb) of ``--sizes``, the core's
   simulator with ``chip_smoke.py`` phase 4's settings (``default_rng(
   20260819)``, 15x, 9 kb reads, 1 kb unitigs, 300 b gaps), then four fresh
   processes in the order card, host, host, card: the card arm with both
   gates at 0, the host arm with both above any count; each process's
   ``assemble`` wall, stage walls, gate counts, peak CUDA memory, its
   first-CUDA cost (the card arm makes its first tensor on the card before
   ``assemble``, so its stage walls hold none of it; the host arm after
   it) and whether the card's context existed after ``assemble``, and the
   three outputs' sha256, equal in all four.
5. ``edges_size`` — for each size of ``--edges-sizes`` (from 4.6 Mb, the
   last size above, to 140 Mb), phase ② alone in four fresh processes,
   card, host, host, card: the PAF read into the match table, then the
   card's or the host's edges, each timed, the two edge tables' sha256
   equal; ``edges_crossover`` reads them as the full runs' crossover does
   (phase ③ is on the card at these sizes, so phase ② pays no context).
6. ``crossover`` — each gate's crossover, from the means of the two runs
   of each arm: the smallest size from which the card arm's stage wall is
   no worse than the host arm's, at that size and every larger one.  The
   suggested threshold is that size's count (match-table rows for phase
   ②, ``2 * graph.size`` for phase ③) rounded down to two significant
   figures, so that where the card wins everywhere it is the smallest
   count measured; where the card loses at the largest size, phase ②'s
   comes from ``edges_crossover`` and, failing that, is
   ``config.GATE_CLOSED``.  The line also gives the mean first-CUDA cost
   after a gated run (what a run whose gates both close spares), which no
   threshold charges.

Prints one JSON line per item and writes them to ``--out/crossover.jsonl``;
the first line names the card and its power limit as ``nvidia-smi`` gives
them.  ``--device cpu`` rehearses the control flow on the CPU, where the
gates always open and no number is a device measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUTPUTS = ("temp_1.target.fa", "temp_1.query.fa", "temp_1.align.paf")
SEED = 20260819


def emit(log, **fields) -> dict:
    line = json.dumps(fields)
    print(line, flush=True)
    if log is not None:
        log.write(line + "\n")
        log.flush()
    return fields


def primary_context_active(index: int = 0) -> bool:
    """Whether the card's primary context exists, by the driver API; the
    query creates none."""
    cuda = ctypes.CDLL("libcuda.so.1")
    dev, flags, active = ctypes.c_int(), ctypes.c_uint(), ctypes.c_int()
    for call in (lambda: cuda.cuInit(0), lambda: cuda.cuDeviceGet(ctypes.byref(dev), index),
                 lambda: cuda.cuDevicePrimaryCtxGetState(dev, ctypes.byref(flags),
                                                         ctypes.byref(active))):
        rc = call()
        if rc != 0:
            raise RuntimeError(f"CUDA driver call failed with {rc}")
    return bool(active.value)


def first_cuda_s(device: str) -> float:
    """Seconds to make a first tensor on the card and wait for it."""
    import torch

    t0 = time.perf_counter()
    torch.ones(1, device=device).add_(1)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def gate_config(arm: str, min_device_batch: int):
    import dataclasses

    from muchsalsa_tpu_torch.config import GATE_CLOSED, Config

    cfg = Config()
    thr = 0 if arm == "card" else GATE_CLOSED
    return dataclasses.replace(cfg, device=dataclasses.replace(
        cfg.device, edges_device_min_rows=thr, chain_device_min_problems=thr,
        min_device_batch=min_device_batch))


def data_paths(data: Path) -> tuple[Path, Path, Path]:
    return data / "truth.paf", data / "unitigs.fa", data / "reads.fa"


def simulate_core(mb: float, data: Path) -> float:
    """Write the core's inputs at ``mb`` Mb into ``data`` with
    ``chip_smoke.py`` phase 4's simulator; returns its seconds."""
    from muchsalsa_tpu_torch.testing.simulate import simulate, write_simulation

    t0 = time.perf_counter()
    sim = simulate(np.random.default_rng(SEED), genome_length=int(mb * 1e6), coverage=15.0,
                   read_length=9_000, unitig_length=1_000, unitig_gap=300)
    write_simulation(sim, data)
    return time.perf_counter() - t0


def read_store(data: Path):
    """The match table of ``data``'s PAF, as the driver's ingest builds it."""
    from muchsalsa_tpu_torch.config import Config
    from muchsalsa_tpu_torch.io.paf import read_paf
    from muchsalsa_tpu_torch.matching.store import MatchStore

    g = Config().graph
    return MatchStore.from_paf(read_paf(
        data_paths(data)[0], min_matches=g.min_matches, th_length=g.th_length,
        th_matches=g.th_matches, skip_last_line=g.skip_last_paf_line))


def assert_no_reference() -> None:
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "muchsalsa_tpu")]
    if loaded:
        raise SystemExit(f"the port loaded {loaded[:8]}")


# ---------------------------------------------------------------------------
# child processes: one assemble each


def child_run(args) -> None:
    """One arm's ``assemble`` in this fresh process; prints one JSON line."""
    from muchsalsa_tpu_torch.assemble.driver import assemble

    on_card = args.device == "cuda"
    cfg = gate_config(args.child, args.min_device_batch)
    row = {"arm": args.child}
    if args.child == "card" and on_card:
        row["first_cuda_s"] = first_cuda_s(args.device)
    t0 = time.perf_counter()
    r = assemble(*data_paths(args.data), args.work, cfg, device=args.device)
    row["assemble_s"] = time.perf_counter() - t0
    if on_card:
        row["context_after_assemble"] = primary_context_active()
        if args.child == "host":
            row["first_cuda_s"] = first_cuda_s(args.device)
    assert_no_reference()
    c = r["timer"].counters
    row.update(
        stages_s=r["timer"].stages,
        counts={k: v for k, v in c.items() if k in (
            "match_rows", "graph_size", "edges_on_device", "chaining_on_device",
            "chain_device_problems", "chain_host_problems") or k.startswith("chain_batch_k")},
        cuda_peak_bytes=r["memory"].get("device_peak_bytes_allocated"),
        sha256={n: hashlib.sha256((args.work / n).read_bytes()).hexdigest() for n in OUTPUTS})
    print(json.dumps(row), flush=True)


def child_edges(args) -> None:
    """Phase ② alone in this fresh process, as the driver runs it: the PAF
    read into the match table, then the card's or the host's edges."""
    from muchsalsa_tpu_torch.config import Config
    from muchsalsa_tpu_torch.matching.edges import build_edges
    from muchsalsa_tpu_torch.matching.edges_torch import build_edges_device

    g = Config().graph
    row = {"arm": args.child.removeprefix("edges_")}
    if row["arm"] == "card" and args.device == "cuda":
        row["first_cuda_s"] = first_cuda_s(args.device)
    t0 = time.perf_counter()
    store = read_store(args.data)
    row["ingest_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if row["arm"] == "card":
        em = build_edges_device(store, g.th_overlap, device=args.device)
    else:
        em = build_edges(store, g.th_overlap)
    row["edges_s"] = time.perf_counter() - t0
    assert_no_reference()
    h = hashlib.sha256()
    for name, value in sorted(vars(em).items()):
        h.update(name.encode())
        h.update(np.ascontiguousarray(value).tobytes())
    row.update(match_rows=len(store), sha256=h.hexdigest())
    print(json.dumps(row), flush=True)


def child_probe(args) -> None:
    """Where a run with both gates closed creates the card's context."""
    steps = []

    def step(name, fn):
        t0 = time.perf_counter()
        fn()
        steps.append({"step": name, "s": time.perf_counter() - t0,
                      "context": primary_context_active()})

    mods = {}

    def imports():
        import torch

        from muchsalsa_tpu_torch.assemble.driver import assemble
        from muchsalsa_tpu_torch.device import resolve_device

        mods.update(torch=torch, assemble=assemble, resolve_device=resolve_device)

    step("import", imports)
    torch = mods["torch"]
    dev = []
    step("resolve_device", lambda: dev.append(mods["resolve_device"](args.device)))
    step("reset_peak_memory_stats", lambda: torch.cuda.reset_peak_memory_stats(dev[0]))
    step("max_memory_allocated", lambda: torch.cuda.max_memory_allocated(dev[0]))
    cfg = gate_config("host", args.min_device_batch)
    step("assemble_gates_closed",
         lambda: mods["assemble"](*data_paths(args.data), args.work, cfg, device=args.device))
    step("first_tensor", lambda: first_cuda_s(args.device))
    print(json.dumps({"steps": steps}), flush=True)


def spawn(args, mode: str, data: Path, work: Path, min_device_batch: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child", mode, "--data", str(data),
           "--work", str(work), "--device", args.device,
           "--min-device-batch", str(min_device_batch)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=args.timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{mode} process exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["process_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# min_device_batch: one bucket's two branches


def core_problem_sizes(data: Path) -> np.ndarray:
    """The anchors of each chaining problem of the core on ``data``: one
    problem an (edge, strand class) of the host edges, as
    ``chaining_phase_device`` groups them."""
    from muchsalsa_tpu_torch.config import Config
    from muchsalsa_tpu_torch.matching.edges import build_edges

    em = build_edges(read_store(data), Config().graph.th_overlap)
    key = em.em_edge.astype(np.int64) * 2 + em.em_direction
    return np.unique(key, return_counts=True)[1]


def bucket_problems(n: int, K: int, seed: int, pool: np.ndarray, low: int):
    """n problems of ``chain_batch``'s random kind, each with more than
    ``low`` and at most K anchors: drawn from ``pool`` (a core's problem
    sizes in that range) where it has any, else uniformly; each problem's
    anchors in the oracle's vStart order.  Returns the flat fields
    ``bucket_batch`` reads, the sizes, the strand classes and one
    ``EdgeContext`` a problem."""
    from muchsalsa_tpu_torch.ops.chaining import EdgeContext
    from muchsalsa_tpu_torch.ops.chaining_torch import _FIELD_MAP
    from muchsalsa_tpu_torch.testing.chains import chain_batch

    b = chain_batch(n, K, "random", seed)
    rng = np.random.default_rng(seed)
    sizes = rng.choice(pool, n) if len(pool) else rng.integers(low + 1, K + 1, n)
    b["valid"] = np.arange(K)[None, :] < sizes[:, None]
    rows = [np.lexsort((np.arange(s), b["v_ne"][i, :s], b["v_ns"][i, :s]))
            for i, s in enumerate(sizes)]
    flat = {_FIELD_MAP[k]: np.concatenate([b[k][i, r] for i, r in enumerate(rows)])
            for k in _FIELD_MAP}
    for k in ("v_dir", "w_dir"):
        flat[k] = np.concatenate([b[k][i, r] for i, r in enumerate(rows)])
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    ints = ("v_ns", "v_ne", "v_is", "v_ie", "w_ns", "w_ne", "w_is", "w_ie",
            "ov_start", "ov_end")
    ctxs = []
    for i, s in enumerate(sizes):
        sl = slice(starts[i], starts[i] + s)
        ctxs.append(EdgeContext(
            v=0, w=1, illu_ids=np.arange(s, dtype=np.int64),
            em_dir=np.full(s, bool(b["cls_dir"][i])), em_primary=np.zeros(s, bool),
            **{k: (flat[k][sl].astype(np.int64) if k in ints else flat[k][sl])
               for k in (*ints, "em_score", "v_rr", "w_rr", "v_dir", "w_dir")}))
    return flat, sizes, b["cls_dir"], ctxs


def host_branch(ctxs, cls_dir, wiggle_room: int) -> list[list[float]]:
    """The oracle's DP of each problem, its ``finalize_paths`` left out."""
    from muchsalsa_tpu_torch.ops import chaining as oracle

    saved = oracle.finalize_paths
    oracle.finalize_paths = lambda ctx, srows, paths, scores, direction: scores
    try:
        return [oracle.max_pairwise_paths(ctx, np.arange(len(ctx.illu_ids)), bool(d),
                                          wiggle_room)
                for ctx, d in zip(ctxs, cls_dir)]
    finally:
        oracle.finalize_paths = saved


def device_branch(flat, sizes, cls_dir, K: int, wiggle_room: int, dev) -> list[list[float]]:
    """The device branch's work for one bucket, up to ``finalize_paths``."""
    from muchsalsa_tpu_torch.ops.chain_scan import chain_dp
    from muchsalsa_tpu_torch.ops.chaining_torch import _reconstruct, bucket_batch

    n = len(sizes)
    B = 1 << int(n - 1).bit_length() if n > 1 else 1
    packed = bucket_batch(flat, np.arange(int(sizes.sum())), sizes, cls_dir, B,
                          pin=dev.type == "cuda")
    s, b = chain_dp(*(x.to(dev, non_blocking=True) for x in packed), K, wiggle_room)
    s_np, b_np = s.cpu().numpy(), b.cpu().numpy()
    return [_reconstruct(s_np[i], b_np[i], int(m))[1] for i, m in enumerate(sizes)]


def median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def crossover(xs: list, card: list[float], host: list[float]):
    """The smallest x from which ``card`` is no worse than ``host``, at x
    and at every larger x; None where it is worse at the largest."""
    best = None
    for x, c, h in sorted(zip(xs, card, host), reverse=True):
        if c > h:
            break
        best = x
    return best


def time_bucket(n: int, K: int, seed: int, pool: np.ndarray, low: int, reps: int, dev):
    """One draw of a bucket: the host branch's and the device branch's
    median ms, their DP scores equal, and the draw's anchors."""
    from muchsalsa_tpu_torch.testing.chains import WIGGLE_ROOM

    flat, sizes, cls_dir, ctxs = bucket_problems(n, K, seed, pool, low)
    t0 = time.perf_counter()
    host = host_branch(ctxs, cls_dir, WIGGLE_ROOM)
    once_ms = (time.perf_counter() - t0) * 1e3
    if host != device_branch(flat, sizes, cls_dir, K, WIGGLE_ROOM, dev):
        raise AssertionError(f"K={K} n={n} seed={seed}: the device branch's DP scores differ")
    for _ in range(2):  # warm: pinned blocks cached, library loaded
        device_branch(flat, sizes, cls_dir, K, WIGGLE_ROOM, dev)
    host_ms = once_ms if once_ms > 500 else median_ms(
        lambda: host_branch(ctxs, cls_dir, WIGGLE_ROOM), reps)
    dev_ms = median_ms(lambda: device_branch(flat, sizes, cls_dir, K, WIGGLE_ROOM, dev), reps)
    return host_ms, dev_ms, int(sizes.sum())


def phase_batch(args, log, card: str, core_sizes: np.ndarray, core_mb: float) -> int:
    import torch

    dev = torch.device(args.device)
    per_k, per_k_draws = {}, {}
    low = 0
    for K in args.ks:
        pool = core_sizes[(core_sizes > low) & (core_sizes <= K)]
        rows = []
        for n in args.ns:
            draws = [time_bucket(n, K, K * 1000 + n + 7919 * s, pool, low, args.reps, dev)
                     for s in range(args.seeds)]
            host_ms, dev_ms, anchors = (list(x) for x in zip(*draws))
            rows.append(emit(log, phase="batch", card=card, K=K, n=n,
                             sizes_from=f"core {core_mb} Mb" if len(pool) else "uniform",
                             anchors=anchors, host_ms=host_ms, device_ms=dev_ms,
                             host_ms_mean=statistics.fmean(host_ms),
                             device_ms_mean=statistics.fmean(dev_ms)))
        ns = [r["n"] for r in rows]
        per_k[K] = crossover(ns, [r["device_ms_mean"] for r in rows],
                             [r["host_ms_mean"] for r in rows])
        per_k_draws[K] = [crossover(ns, [r["device_ms"][s] for r in rows],
                                    [r["host_ms"][s] for r in rows])
                          for s in range(args.seeds)]
        low = K
    losing = [K for K, x in per_k.items() if x is None]
    suggested = None if losing else max(per_k.values())
    emit(log, phase="batch_crossover", card=card, per_k=per_k, per_k_each_draw=per_k_draws,
         card_loses_at_largest_n=losing, suggested_min_device_batch=suggested)
    return suggested if suggested is not None else max(args.ns) + 1


# ---------------------------------------------------------------------------


def floor2(x: int) -> int:
    """``x`` rounded down to two significant figures."""
    e = 10 ** max(len(str(int(x))) - 2, 0)
    return int(x) // e * e


def summarise(log, card: str, rows: list[dict], first_cuda: float) -> None:
    """Each gate's crossover by its stage walls, and the suggested
    threshold at it."""
    sizes = [r["genome_mb"] for r in rows]
    count_of = {"edges": "match_rows", "chaining": "two_graph_size"}
    out = {}
    for st in ("edges", "chaining"):
        walls = {arm: [statistics.fmean(run["stages_s"][st] for run in r["runs"]
                                        if run["arm"] == arm) for r in rows]
                 for arm in ("card", "host")}
        at = crossover(sizes, walls["card"], walls["host"])
        out[st] = {
            "card_s": walls["card"], "host_s": walls["host"], "crossover_mb": at,
            "card_wins_everywhere": at == min(sizes),
            # None: the card loses at the largest size measured
            "suggested": None if at is None else floor2(
                next(r[count_of[st]] for r in rows if r["genome_mb"] == at))}
    emit(log, phase="crossover", card=card, first_cuda_s=first_cuda, sizes_mb=sizes,
         suggested_edges_device_min_rows=out["edges"]["suggested"],
         suggested_chain_device_min_problems=out["chaining"]["suggested"], **out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="0.05,0.1,0.25,0.5,1,2,4.6",
                    help="genome sizes in Mb, ascending")
    ap.add_argument("--ks", default="8,16,32,64,128")
    ap.add_argument("--ns", default="1,4,16,32,64,256")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seeds", type=int, default=5, help="draws of each (K, n) bucket")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "gate_crossover")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a process may take")
    ap.add_argument("--edges-sizes", default="4.6,8,12,20,40,80,140",
                    help="larger genome sizes in Mb, ascending, where phase ② alone is timed")
    ap.add_argument("--child", choices=("card", "host", "probe", "edges_card", "edges_host"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--data", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--work", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--min-device-batch", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child == "probe":
        return child_probe(args)
    if args.child in ("edges_card", "edges_host"):
        return child_edges(args)
    if args.child:
        return child_run(args)

    def numbers(text, kind):
        return [kind(x) for x in text.split(",") if x]

    args.ks, args.ns = numbers(args.ks, int), numbers(args.ns, int)
    sizes, edges_sizes = numbers(args.sizes, float), numbers(args.edges_sizes, float)

    import torch

    from muchsalsa_tpu_torch import kernels, native
    from muchsalsa_tpu_torch.config import GATE_CLOSED, DeviceConfig

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: this script measures the card (--device cpu "
                               "rehearses it)")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0].strip()
    else:
        card = "cpu rehearsal: no device measurement"
    args.out.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    with open(args.out / "crossover.jsonl", "w") as log, \
            tempfile.TemporaryDirectory(prefix="ms_gate_") as td:
        print(card, flush=True)
        emit(log, phase="setup", card=card, torch=torch.__version__, cuda=torch.version.cuda,
             sizes_mb=sizes)
        t0 = time.perf_counter()
        cold = None
        if args.device == "cuda":
            cold = not kernels.library_path().is_file()
            kernels.build()
        nvcc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        native_ok = native._load() is not None
        emit(log, phase="build", card=card, nvcc_cold=cold, nvcc_s=nvcc_s, native=native_ok,
             native_s=time.perf_counter() - t0)

        work = Path(td)
        mdb = DeviceConfig.min_device_batch
        if args.ks:
            core_mb = max(sizes, default=4.6)
            simulate_core(core_mb, work / "core_sizes")
            core_sizes = core_problem_sizes(work / "core_sizes")
            shutil.rmtree(work / "core_sizes")
            mdb = phase_batch(args, log, card, core_sizes, core_mb)

        rows = []
        for i, mb in enumerate(sizes):
            data = work / f"data_{mb}"
            sim_s = simulate_core(mb, data)
            if i == 0 and args.device == "cuda":
                emit(log, phase="probe", card=card, genome_mb=mb,
                     **spawn(args, "probe", data, work / "probe", mdb))
            runs = [spawn(args, arm, data, work / f"out_{mb}_{j}", mdb)
                    for j, arm in enumerate(("card", "host", "host", "card"))]
            if len({json.dumps(r["sha256"], sort_keys=True) for r in runs}) != 1:
                raise AssertionError(f"{mb} Mb: the arms' outputs differ")
            card_runs = [r for r in runs if r["arm"] == "card"]
            c = card_runs[0]["counts"]
            if args.device == "cuda":
                placed = [(r["arm"], r["counts"]["edges_on_device"],
                           r["counts"]["chaining_on_device"]) for r in runs]
                if any((e, ch) != ((1, 1) if arm == "card" else (0, 0))
                       for arm, e, ch in placed):
                    raise AssertionError(f"{mb} Mb: the gates did not decide as set: {placed}")
            rows.append(emit(
                log, phase="size", card=card, genome_mb=mb, simulate_s=sim_s,
                match_rows=c["match_rows"], two_graph_size=2 * c["graph_size"],
                chain_problems=c["chain_device_problems"] + c["chain_host_problems"],
                min_device_batch=mdb, runs=runs))
        if rows:
            # what a closed gate spares: the host arm's first tensor on the
            # card, made after its run
            first = statistics.fmean(r["first_cuda_s"] for row in rows for r in row["runs"]
                                     if r["arm"] == "host") if args.device == "cuda" else 0.0
            summarise(log, card, rows, first)

        edge_rows = []
        for mb in edges_sizes:
            data = work / f"data_{mb}"
            sim_s = simulate_core(mb, data)
            runs = [spawn(args, f"edges_{arm}", data, work / "unused", mdb)
                    for arm in ("card", "host", "host", "card")]
            if len({r["sha256"] for r in runs}) != 1:
                raise AssertionError(f"{mb} Mb: the arms' edges differ")
            edge_rows.append(emit(log, phase="edges_size", card=card, genome_mb=mb,
                                  simulate_s=sim_s, match_rows=runs[0]["match_rows"],
                                  runs=runs))
            shutil.rmtree(data)
        if edge_rows:
            # at these sizes phase ③ is on the card, so phase ② pays no context
            walls = {arm: [statistics.fmean(r["edges_s"] for r in row["runs"] if r["arm"] == arm)
                           for row in edge_rows] for arm in ("card", "host")}
            at = crossover(edges_sizes, walls["card"], walls["host"])
            emit(log, phase="edges_crossover", card=card, sizes_mb=edges_sizes,
                 card_s=walls["card"], host_s=walls["host"], crossover_mb=at,
                 match_rows=[r["match_rows"] for r in edge_rows],
                 # no crossover up to the largest size: the gate stays closed
                 suggested=GATE_CLOSED if at is None else floor2(
                     next(r["match_rows"] for r in edge_rows if r["genome_mb"] == at)))
        emit(log, phase="done", card=card, seconds=time.perf_counter() - t_start)


if __name__ == "__main__":
    main()
