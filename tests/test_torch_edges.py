"""The port's device edge construction against the JAX package's.

Mirrors tests/test_edges_jax.py: the port's ``build_edges_device`` must
give the same ``EdgeMatches`` as ``muchsalsa_tpu.matching.edges_jax`` and
as the host ``build_edges``, field by field.  Each package gets its own
``MatchStore`` of the same PAF.  Tolerance: exact equality (integer
fields, and float64 scores computed by the same host code).
"""

import numpy as np
import pytest
import torch

from muchsalsa_tpu.io.paf import PafRecords, read_paf
from muchsalsa_tpu.io.registry import Registry
from muchsalsa_tpu.matching.edges import build_edges
from muchsalsa_tpu.matching.edges_jax import build_edges_device as jax_build_edges_device
from muchsalsa_tpu.matching.store import MatchStore
from muchsalsa_tpu.testing.simulate import simulate, write_simulation
from muchsalsa_tpu_torch.io import paf as port_paf
from muchsalsa_tpu_torch.io.registry import Registry as PortRegistry
from muchsalsa_tpu_torch.matching.edges import build_edges as port_build_edges
from muchsalsa_tpu_torch.matching.edges_torch import build_edges_device, scaffold_pairs_device
from muchsalsa_tpu_torch.matching.store import MatchStore as PortMatchStore
from tests.test_edges_jax import _assert_equal


def _stores(tmp_path, seed=3, glen=40_000):
    """The JAX package's store and the port's, read from one PAF."""
    rng = np.random.default_rng(seed)
    sim = simulate(rng, genome_length=glen, coverage=9.0, both_strands=True)
    paths = write_simulation(sim, tmp_path / "data")
    records = read_paf(paths["paf"], registry_nanopore=Registry(),
                       registry_illumina=Registry())
    port_records = port_paf.read_paf(paths["paf"], registry_nanopore=PortRegistry(),
                                     registry_illumina=PortRegistry())
    return MatchStore.from_paf(records), PortMatchStore.from_paf(port_records)


def _empty_store(records_cls, registry_cls, store_cls):
    z32 = np.zeros(0, dtype=np.int32)
    return store_cls.from_paf(records_cls(
        illu_id=z32, nano_id=z32, illu_start=z32, illu_end=z32,
        nano_start=z32, nano_end=z32, nano_length=z32,
        direction=np.zeros(0, dtype=bool), score=np.zeros(0, dtype=np.int64),
        is_primary=np.zeros(0, dtype=bool),
        line_idx=np.zeros(0, dtype=np.int64),
        registry_nanopore=registry_cls(), registry_illumina=registry_cls()))


@pytest.mark.parametrize("seed,max_scaffold", [
    (3, 256),
    (5, 256),
    # scaffolds above the cap run through the host pair path
    (3, 4),
])
def test_port_edges_match_jax_and_host(tmp_path, seed, max_scaffold):
    store, port_store = _stores(tmp_path, seed=seed)
    got = build_edges_device(port_store, max_scaffold=max_scaffold, device="cpu")
    assert got.n_edges > 0
    _assert_equal(got, jax_build_edges_device(store, max_scaffold=max_scaffold))
    _assert_equal(got, build_edges(store))
    _assert_equal(got, port_build_edges(port_store))


def test_port_edges_empty():
    store = _empty_store(PafRecords, Registry, MatchStore)
    port_store = _empty_store(port_paf.PafRecords, PortRegistry, PortMatchStore)
    _assert_equal(build_edges_device(port_store, device="cpu"), jax_build_edges_device(store))


def test_scaffold_pairs_match_jax():
    from muchsalsa_tpu.matching.edges_jax import scaffold_pairs_device as jax_pairs

    rng = np.random.default_rng(11)
    G, K = 6, 16
    ist = rng.integers(0, 2_000, (G, K)).astype(np.int32)
    ien = (ist + rng.integers(50, 800, (G, K))).astype(np.int32)
    valid = rng.random((G, K)) < 0.8
    ref = jax_pairs(ist, ien, valid, 100)
    got = scaffold_pairs_device(
        torch.from_numpy(ist), torch.from_numpy(ien), torch.from_numpy(valid), 100)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # the nonzero order the host merge relies on: row-major (g, j, i)
    np.testing.assert_array_equal(
        torch.nonzero(got[2]).numpy(), np.stack(np.nonzero(np.asarray(ref[2])), axis=1))
