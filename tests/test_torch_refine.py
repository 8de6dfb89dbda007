"""The port's alignment refinement and ``map_all`` against the JAX package.

A simulated genome (numpy, from a seed) with nanopore-style noise on the
reads is mapped on the host; the same mappings are refined by the JAX
package and by the port on the CPU, and the whole ``map_all`` with
``cfg.refine`` is run by both, each package on its own stores, index and
mappings of the same sequences.  Tolerance: exact equality of every
mapping's ``matches`` and of every PAF line.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from muchsalsa_tpu.config import MapperConfig
from muchsalsa_tpu.io.fasta import SequenceStore
from muchsalsa_tpu.ops.align import pack_problems as jax_pack_problems
from muchsalsa_tpu.ops.myers_pallas import myers_banded_pallas
from muchsalsa_tpu.pipeline import mapper as jax_mapper
from muchsalsa_tpu.testing.simulate import add_noise, simulate
from muchsalsa_tpu.utils.seq import reverse_complement
from muchsalsa_tpu_torch.config import MapperConfig as PortMapperConfig
from muchsalsa_tpu_torch.io.fasta import SequenceStore as PortStore
from muchsalsa_tpu_torch.ops.myers_torch import myers_edit_distance
from muchsalsa_tpu_torch.pipeline import mapper as port_mapper
from muchsalsa_tpu_torch.pipeline import mapper_torch


def _dataset(store_cls, cfg_cls, mapper):
    """~30 kb genome, 8x of 5 kb reads with 8 % noise, 1 kb unitigs, in one
    package's stores: (unitigs, reads, config, index, host mappings)."""
    sim = simulate(np.random.default_rng(41), genome_length=30_000, coverage=8.0,
                   read_length=5_000)
    unitigs = store_cls()
    for name, seq in sim.unitig_records():
        unitigs.add(name, seq)
    reads = store_cls()
    rng = np.random.default_rng(1)
    for name, seq in sim.read_records():
        reads.add(name, add_noise(rng, seq, 0.08))
    cfg = cfg_cls()
    index = mapper.MinimizerIndex.build(unitigs, cfg)
    per_read = [(rid, mapper.map_read(index, seq, cfg)) for rid, seq in reads.items()]
    assert sum(len(maps) for _, maps in per_read) > 20
    return unitigs, reads, cfg, index, per_read


@pytest.fixture(scope="module")
def dataset():
    """The JAX package's objects."""
    return _dataset(SequenceStore, MapperConfig, jax_mapper)


@pytest.fixture(scope="module")
def port_dataset():
    """The port's objects of the same sequences."""
    return _dataset(PortStore, PortMapperConfig, port_mapper)


def matches(per_read):
    return [m.matches for _, maps in per_read for m in maps]


def refined(dataset, refine, **kw):
    unitigs, reads, _, _, per_read = dataset
    mine = copy.deepcopy(per_read)
    refine(mine, reads, unitigs, **kw)
    return matches(mine)


@pytest.mark.parametrize("engine,band", [("myers", 256), ("wavefront", 256), ("wavefront", 128)])
def test_refine_mappings_matches_jax(dataset, port_dataset, engine, band):
    before = matches(dataset[4])
    assert matches(port_dataset[4]) == before
    want = refined(dataset, jax_mapper.refine_mappings, band=band, engine=engine,
                   use_pallas=False)
    got = refined(port_dataset, mapper_torch.refine_mappings, band=band, engine=engine,
                  use_pallas=False, device="cpu")
    assert got == want
    assert got != before


def test_refine_mappings_use_pallas_none_on_cpu_is_the_wavefront(port_dataset):
    assert (refined(port_dataset, mapper_torch.refine_mappings, engine="wavefront",
                    device="cpu")
            == refined(port_dataset, mapper_torch.refine_mappings, engine="wavefront",
                       use_pallas=False, device="cpu"))


@pytest.mark.parametrize("band", (128, 256))
def test_refine_mappings_banded_myers_matches_pallas(dataset, port_dataset, band):
    """The JAX branch would compile for a TPU, so the reference applies
    the interpret-mode Pallas distances to the JAX-packed regions itself."""
    unitigs, reads, _, _, per_read = dataset
    want = copy.deepcopy(per_read)
    pairs, slots = [], []
    for rid, maps in want:
        for m in maps:
            q = unitigs.sequence(m.unitig)[m.q_start:m.q_end]
            t = reads.sequence(rid)[m.t_start:m.t_end]
            t = t if m.strand else reverse_complement(t)
            if abs(len(q) - len(t)) < band:
                pairs.append((q, t))
                slots.append(m)
    dists = np.asarray(myers_banded_pallas(
        *jax_pack_problems(pairs), window_words=max(band // 32, 2), interpret=True))
    for m, (q, t), d in zip(slots, pairs, dists):
        if d >= 0:
            m.matches = max(len(q), len(t)) - int(d)
    got = refined(port_dataset, mapper_torch.refine_mappings, band=band, engine="wavefront",
                  use_pallas=True, device="cpu")
    assert got == matches(want)


@pytest.mark.parametrize("engine", ("myers", "wavefront"))
def test_refine_mappings_gathers_from_coordinates(dataset, port_dataset, monkeypatch, engine):
    """Refinement builds its batch from the mappings' coordinates: it never
    packs sliced pairs on the host, and gives the JAX package's matches."""
    from muchsalsa_tpu_torch.ops import align_torch

    want = refined(dataset, jax_mapper.refine_mappings, band=256, engine=engine,
                   use_pallas=False)

    def no_host_packing(pairs):
        raise AssertionError("refine_mappings packed sliced pairs on the host")

    monkeypatch.setattr(align_torch, "pack_problems", no_host_packing)
    monkeypatch.setattr(mapper_torch, "pack_problems", no_host_packing, raising=False)
    stats = {}
    got = refined(port_dataset, mapper_torch.refine_mappings, band=256, engine=engine,
                  use_pallas=False, device="cpu", stats=stats)
    assert got == want
    assert stats["card_packed"] == 0  # CPU tensors: the plain version built the batch
    assert stats["packed"][0].shape == (stats["problems"], stats["M"])


def test_map_all_with_refinement_matches_jax(dataset, port_dataset):
    unitigs, reads, cfg, index, _ = dataset
    cfg = dataclasses.replace(cfg, refine=True)
    names = dict(unitig_names=lambda u: unitigs.registry.name(u),
                 read_names=lambda r: reads.registry.name(r))
    want = jax_mapper.map_all(index, reads, cfg, unitigs=unitigs, **names)
    unitigs, reads, cfg, index, _ = port_dataset
    cfg = dataclasses.replace(cfg, refine=True)
    stats = {}
    before = myers_edit_distance.launches
    got = mapper_torch.map_all(index, reads, cfg, unitigs=unitigs, device=False,
                               torch_device="cpu", stats=stats, **names)
    assert got == want
    assert myers_edit_distance.launches == before  # CPU tensors: the plain version
    unrefined = mapper_torch.map_all(index, reads, dataclasses.replace(cfg, refine=False),
                                     unitigs=unitigs, device=False, torch_device="cpu",
                                     **names)
    assert len(unrefined) == len(got) and unrefined != got
    assert stats["problems"] == len(got)
    assert stats["packed"][0].shape == (stats["problems"], stats["M"])
    assert stats["packed"][0].device.type == "cpu"


def test_map_all_device_mapping_raises(dataset, port_dataset, monkeypatch):
    """Device mapping asked of a machine without a card raises, and it is
    the default; it never maps on the host instead."""
    _, j_reads, j_cfg, j_index, _ = dataset
    unitigs, reads, cfg, index, _ = port_dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({"device": True}, {}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mapper_torch.map_all(index, reads, cfg, **kw)
    assert (mapper_torch.map_all(index, reads, cfg, device=False)
            == jax_mapper.map_all(j_index, j_reads, j_cfg))


def test_cuda_request_without_a_card_raises(port_dataset, monkeypatch):
    unitigs, reads, cfg, index, per_read = port_dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mapper_torch.map_all(index, reads, dataclasses.replace(cfg, refine=True),
                             unitigs=unitigs, device=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mapper_torch.refine_mappings(copy.deepcopy(per_read), reads, unitigs, device="cuda")
    with pytest.raises(ValueError):
        mapper_torch.refine_mappings(copy.deepcopy(per_read), reads, unitigs, device="meta")


def test_port_map_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys; import muchsalsa_tpu_torch.pipeline.mapper_torch; "
            "assert 'jax' not in sys.modules, 'jax loaded'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
