"""The plain reference against the port's host mapper, and its edit
distance against a textbook one, at small sizes on the CPU."""


import numpy as np
import pytest
import torch

from portbench import harness, reference, sim
from portbench.reference import edit
from portbench.tests.common import TINY


def _program_lines(inputs, traffic, device_map, monkeypatch=None, force_v1=False):
    from muchsalsa_tpu_torch.pipeline import mapper_torch

    if force_v1:
        monkeypatch.setattr(mapper_torch, "build_device_tables", lambda *a, **k: None)
    mc, _params = harness.mapper_params(traffic)
    unitigs = harness.store_of(inputs.unitig_records())
    reads = harness.store_of(inputs.read_records())
    index = mapper_torch.MinimizerIndex.build(unitigs, mc)
    return mapper_torch.map_all(index, reads, mc, unitig_names=unitigs.registry.name,
                                read_names=reads.registry.name, unitigs=unitigs,
                                device=device_map, torch_device="cpu")


@pytest.mark.parametrize("workload", ["ecoli.map", "ecoli.map_refine"])
@pytest.mark.parametrize("device_map", [False, True], ids=["host", "v2"])
def test_reference_equals_the_port(workload, device_map):
    _cell, config, traffic = harness.cell_parts(harness.load_benchmark(), workload)
    inputs = sim.make_inputs(dict(config, **TINY), 2**31 + 3, "cpu")
    run = harness.Run({}, config, traffic, 0, "cpu", inputs=inputs)
    want = harness.reference_lines(run)
    assert len(want) > 50
    assert _program_lines(inputs, traffic, device_map) == want


def test_reference_equals_the_v1_join(monkeypatch):
    _cell, config, traffic = harness.cell_parts(harness.load_benchmark(), "dmel.map")
    inputs = sim.make_inputs(dict(config, **TINY), 2**31 + 4, "cpu")
    run = harness.Run({}, config, traffic, 0, "cpu", inputs=inputs)
    assert _program_lines(inputs, traffic, True, monkeypatch, force_v1=True) == \
        harness.reference_lines(run)


def _levenshtein(a, b):
    d = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, d[0] = d[0], i
        for j, y in enumerate(b, 1):
            cur = min(d[j] + 1, d[j - 1] + 1, prev + (x != y or x >= 4))
            prev, d[j] = d[j], cur
    return d[-1]


def test_edit_distance_is_levenshtein():
    rng = np.random.default_rng(7)
    pairs = [(rng.integers(0, 5, rng.integers(0, 40)), rng.integers(0, 5, rng.integers(0, 40)))
             for _ in range(60)]
    pairs += [(np.array([4, 4]), np.array([4, 4])), (np.array([], int), np.array([1, 2]))]
    M = max(len(q) for q, _ in pairs) or 1
    N = max(len(t) for _, t in pairs) or 1
    q = torch.full((len(pairs), M), 5, dtype=torch.uint8)
    t = torch.full((len(pairs), N), 4, dtype=torch.uint8)
    for i, (a, b) in enumerate(pairs):
        q[i, : len(a)] = torch.from_numpy(a.astype(np.uint8))
        t[i, : len(b)] = torch.from_numpy(b.astype(np.uint8))
    qn = torch.tensor([len(a) for a, _ in pairs])
    tn = torch.tensor([len(b) for _, b in pairs])
    got = edit.distance(q, qn, t, tn, cells=N * 7)   # several blocks
    assert got.tolist() == [_levenshtein(a.tolist(), b.tolist()) for a, b in pairs]


def test_fmix32_is_murmur3():
    x = torch.tensor([0, 1, 0x3FFFFFFF, 123456789])

    def ref(v):
        v ^= v >> 16
        v = (v * 0x85EBCA6B) & 0xFFFFFFFF
        v ^= v >> 13
        v = (v * 0xC2B2AE35) & 0xFFFFFFFF
        return v ^ (v >> 16)

    assert reference.mapper.fmix32(x).tolist() == [ref(int(v)) for v in x]


def test_sketch_of_short_and_invalid_sequences():
    from portbench.reference.mapper import Params, sketch

    p = Params()
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in (0, 10, 15, 17, 19, 40, 300)]
    seqs[5][20] = 4
    codes = torch.from_numpy(np.concatenate(seqs))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum([len(s) for s in seqs])]))
    seq, pos, h, strand = sketch(codes, offsets, p)

    from muchsalsa_tpu_torch.ops.minimizer import minimizers

    for s, codes_s in enumerate(seqs):
        want = minimizers(codes_s, p.k, p.w)
        mine = seq == s
        assert pos[mine].tolist() == want[0].tolist()
        assert h[mine].tolist() == want[1].tolist()
        assert strand[mine].tolist() == want[2].tolist()
