"""The port's device-batched chaining phase against the exact host oracle.

Mirrors tests/test_chaining_jax.py with the port's
``chaining_phase_device(device="cpu", min_device_batch=1)``, so every
bucket goes through ``chain_scan``.  The JAX package's oracle runs on its
own objects and the port on its own, built from the same match rows.
Tolerance: exact equality of every edge's shadow flag and overlap orders.
"""

import dataclasses

import numpy as np
import pytest

from muchsalsa_tpu.assemble.driver import build_graph, chaining_phase
from muchsalsa_tpu.io.paf import read_paf
from muchsalsa_tpu.matching.edges import build_edges
from muchsalsa_tpu.matching.store import MatchStore
from muchsalsa_tpu.testing.simulate import simulate, write_simulation
from muchsalsa_tpu_torch.assemble import host as port_host
from muchsalsa_tpu_torch.io.paf import PafRecords as PortPafRecords
from muchsalsa_tpu_torch.io.registry import Registry as PortRegistry
from muchsalsa_tpu_torch.matching.edges import build_edges as port_build_edges
from muchsalsa_tpu_torch.matching.store import MatchStore as PortMatchStore
from muchsalsa_tpu_torch.ops.chaining_torch import chaining_phase_device
from tests.test_chaining_jax import random_records


def port_records(rec):
    """The port's ``PafRecords`` of the JAX package's: the same arrays, and
    registries holding the same names in the same order."""
    fields = {f.name: getattr(rec, f.name) for f in dataclasses.fields(rec)}
    for key in ("registry_nanopore", "registry_illumina"):
        reg = PortRegistry()
        for name in fields[key].names():
            reg[name]
        fields[key] = reg
    return PortPafRecords(**fields)


def snapshot(graph):
    """Each edge's shadow flag and overlap orders, as plain values."""
    return {(e.v, e.w): (e.shadow, tuple(dataclasses.astuple(o) for o in e.orders))
            for e in graph.edges()}


def _stores(case, seed, tmp_path):
    """The JAX package's store and the port's, of the same match rows."""
    rng = np.random.default_rng(seed)
    if case == "random":
        rec = random_records(rng)
    elif case == "oversized":
        rec = random_records(rng, n_reads=4, n_units=40, n_rows=600)
    else:
        sim = simulate(rng, genome_length=40_000, coverage=10.0)
        rec = read_paf(write_simulation(sim, tmp_path)["paf"])
    return MatchStore.from_paf(rec), PortMatchStore.from_paf(port_records(rec))


@pytest.mark.parametrize("case,seed,buckets", [
    ("random", 0, (8, 16, 32, 64, 128)),
    ("random", 1, (8, 16, 32, 64, 128)),
    ("random", 2, (8, 16, 32, 64, 128)),
    ("random", 3, (8, 16, 32, 64, 128)),
    ("simulated", 99, (8, 16, 32, 64, 128)),
    # a small largest bucket sends the big problems to the host oracle:
    # all of them with (4, 8), some with (8, 16)
    ("oversized", 7, (4, 8)),
    ("oversized", 7, (8, 16)),
])
def test_device_chaining_equals_oracle(case, seed, buckets, tmp_path):
    store, port_store = _stores(case, seed, tmp_path)
    em = build_edges(store)
    assert em.n_edges > 0

    g_host = build_graph(store, em)
    chaining_phase(g_host, store, em, 300)
    port_em = port_build_edges(port_store)
    g_dev = port_host.build_graph(port_store, port_em)
    placed = chaining_phase_device(
        g_dev, port_store, port_em, 300, chain_buckets=buckets, min_device_batch=1,
        device="cpu")

    assert snapshot(g_host) == snapshot(g_dev)
    assert placed["device_problems"] > 0 or buckets == (4, 8)
    assert placed["host_problems"] > 0 or case != "oversized"


def test_small_buckets_stay_on_host():
    """A bucket with fewer problems than ``min_device_batch`` runs on the
    oracle; the result is unchanged."""
    store, port_store = _stores("random", 0, None)
    em = build_edges(store)
    g_host = build_graph(store, em)
    chaining_phase(g_host, store, em, 300)
    port_em = port_build_edges(port_store)
    g_dev = port_host.build_graph(port_store, port_em)
    placed = chaining_phase_device(g_dev, port_store, port_em, 300, min_device_batch=10**9,
                                   device="cpu")
    assert placed["device_problems"] == 0 and placed["host_problems"] > 0
    assert snapshot(g_host) == snapshot(g_dev)
