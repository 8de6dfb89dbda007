"""The port's scrub with its device all-vs-all against the JAX package's.

The reads are test_distributed_scrub.py's (10 reads of 7 kb tiling a 40 kb
genome made from a numpy seed, and 9 unitigs across their joins), mapped by
the JAX package's host mapper into the PAF both scrubs read.  The port maps
each subset on CPU tensors (its device mapper's plain torch path), the JAX
package on the CPU.  Tolerance: identical records and mappings, in order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from muchsalsa_tpu.config import MapperConfig as JaxMapperConfig
from muchsalsa_tpu.config import ScrubConfig as JaxScrubConfig
from muchsalsa_tpu.io.fasta import SequenceStore as JaxSequenceStore
from muchsalsa_tpu.pipeline.mapper import MinimizerIndex as JaxMinimizerIndex
from muchsalsa_tpu.pipeline.mapper import map_all as jax_map_all
from muchsalsa_tpu.pipeline.scrubber import _device_all_vs_all as jax_device_all_vs_all
from muchsalsa_tpu.pipeline.scrubber import scrub_reads as jax_scrub_reads
from muchsalsa_tpu.testing.simulate import random_genome
from muchsalsa_tpu_torch.config import MapperConfig, ScrubConfig
from muchsalsa_tpu_torch.io.fasta import SequenceStore
from muchsalsa_tpu_torch.pipeline import scrubber
from muchsalsa_tpu_torch.pipeline.scrubber import (
    SCRUB_DEVICE_STATS, _device_all_vs_all, scrub_reads)


def tiled_reads(seed, n_reads=10, step=3600, read_len=7000):
    """(genome, reads as {name: bytes}, unitigs as {name: bytes}): reads
    tiling the genome, unitigs across each pair of neighbouring reads."""
    genome = random_genome(np.random.default_rng(seed), step * n_reads + read_len)
    reads = {f"r{i}": genome[i * step : i * step + read_len] for i in range(n_reads)}
    unitigs = {f"u{i}": genome[i * step + 3000 : i * step + 4200] for i in range(n_reads - 1)}
    return genome, reads, unitigs


def stores(records):
    """The same records in a JAX-package store and a port store."""
    jax_store, store = JaxSequenceStore(), SequenceStore()
    for name, seq in records.items():
        jax_store.add(name, seq)
        store.add(name, seq)
    return jax_store, store


def paf_of(reads, unitigs):
    """The JAX package's host mapping of the unitigs onto the reads."""
    jax_reads, _ = stores(reads)
    jax_unitigs, _ = stores(unitigs)
    mcfg = JaxMapperConfig()
    return jax_map_all(JaxMinimizerIndex.build(jax_unitigs, mcfg), jax_reads, mcfg)


def as_tuples(per_read):
    return [(rid, [dataclasses.astuple(m) for m in maps]) for rid, maps in per_read]


@pytest.fixture(scope="module")
def tiled():
    _genome, reads, unitigs = tiled_reads(78)
    return reads, paf_of(reads, unitigs)


def test_device_scrub_matches_jax_and_host(tiled):
    reads, paf = tiled
    jax_reads, port_reads = stores(reads)
    want = jax_scrub_reads(paf, jax_reads, JaxScrubConfig(subset_size=3), JaxMapperConfig(),
                           device=True)
    assert want == jax_scrub_reads(paf, jax_reads, JaxScrubConfig(subset_size=3),
                                   JaxMapperConfig())
    got = scrub_reads(paf, port_reads, ScrubConfig(subset_size=3), MapperConfig(),
                      device="cpu")
    assert got == want and got
    assert got == scrub_reads(paf, port_reads, ScrubConfig(subset_size=3), MapperConfig())
    stats = dict(SCRUB_DEVICE_STATS)
    assert stats["device"] == "cpu" and stats["on_device"] >= 1 and stats["declined"] == 0
    assert len(stats["subsets"]) == stats["on_device"]
    assert all(s["chunks"] == 1 and 0 < s["multiplicity"] <= 4 for s in stats["subsets"])
    # the device mapper's counters of each subset: every read mapped once,
    # some of them by the host mapper
    assert all(0 <= s["overflow_reads"] <= s["total_reads"] > 0 for s in stats["subsets"])


def test_chunked_all_vs_all_matches_single_chunk():
    """One index chunk a read (entry budget ~ one read's minimizers) gives
    the single-index per-read hit lists, order included, which equal the
    JAX package's; the rebase of chunk-local ids leaks into no later call."""
    _genome, reads, _unitigs = tiled_reads(79)
    jax_store, store = stores(reads)
    want, _ = jax_device_all_vs_all(jax_store, JaxMapperConfig())
    single, _idx = _device_all_vs_all(store, MapperConfig(), device="cpu")
    assert any(maps for _rid, maps in single), "the reads must overlap"
    assert as_tuples(single) == as_tuples(want)
    SCRUB_DEVICE_STATS.clear()
    chunked, _idx2 = _device_all_vs_all(store, MapperConfig(), entry_budget=3_000,
                                        max_chunks=99, device="cpu")
    assert as_tuples(chunked) == as_tuples(single)
    assert SCRUB_DEVICE_STATS["subsets"][0]["chunks"] == len(reads)
    again, _idx3 = _device_all_vs_all(store, MapperConfig(), device="cpu")
    assert as_tuples(again) == as_tuples(single)


def test_chunked_scrub_matches_host(tiled, monkeypatch):
    reads, paf = tiled
    _jax_reads, port_reads = stores(reads)
    host = scrub_reads(paf, port_reads, ScrubConfig(subset_size=3), MapperConfig())
    orig = scrubber._device_all_vs_all
    monkeypatch.setattr(scrubber, "_device_all_vs_all",
                        lambda s, m, device: orig(s, m, 3_000, max_chunks=99, device=device))
    got = scrub_reads(paf, port_reads, ScrubConfig(subset_size=3), MapperConfig(),
                      device="cpu")
    assert got == host
    assert SCRUB_DEVICE_STATS["declined"] == 0
    assert any(s["chunks"] > 1 for s in SCRUB_DEVICE_STATS["subsets"])


def test_high_multiplicity_subset_declines_visibly(capsys):
    """Reads that overlap ten deep give an index multiplicity above 4: the
    guard declines, prints its line and counts the subset, and the scrub
    still equals the host's and the JAX package's."""
    _genome, reads, unitigs = tiled_reads(80, n_reads=12, step=400, read_len=5000)
    paf = paf_of(reads, unitigs)
    jax_reads, port_reads = stores(reads)
    host = scrub_reads(paf, port_reads, ScrubConfig(subset_size=20), MapperConfig())
    capsys.readouterr()
    got = scrub_reads(paf, port_reads, ScrubConfig(subset_size=20), MapperConfig(),
                      device="cpu")
    assert "[scrub] device ava declined: multiplicity" in capsys.readouterr().out
    assert got == host and got
    assert got == jax_scrub_reads(paf, jax_reads, JaxScrubConfig(subset_size=20),
                                  JaxMapperConfig(), device=True)
    stats = dict(SCRUB_DEVICE_STATS)
    assert stats["declined"] == 1 and stats["on_device"] == 0
    assert stats["subsets"][0]["declined"] and stats["subsets"][0]["multiplicity"] > 4


def test_scrub_refuses_what_it_cannot_run(tiled, monkeypatch):
    reads, paf = tiled
    _jax_reads, port_reads = stores(reads)
    # several processes with no allgather to exchange their records
    with pytest.raises(ValueError, match="needs an allgather"):
        scrub_reads(paf, port_reads, process_count=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scrub_reads(paf, port_reads, ScrubConfig(subset_size=3), device="cuda")
