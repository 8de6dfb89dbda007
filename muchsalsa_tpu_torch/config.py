"""Typed configuration for the whole assembler.

The reference scatters its tunables across compile-time constants; this
module lifts every one of them into a single dataclass (see SURVEY.md §5
"Config / flag system").  Field-by-field provenance:

- ``min_matches`` / ``th_length`` / ``th_matches``:
  reference ``libms/src/BlastFileReader.cpp:48-50``.
- ``th_overlap``: ``libms/src/matching/MatchMap.cpp:41``.
- ``wiggle_room``: ``src/Application.h:132`` (default 300).
- ``base_weight_multiplicator`` / ``max_weight_multiplicator``:
  ``src/main.cpp:96-97``.
- ``th_sequence_length`` / ``sequence_line_length``: ``libms/src/kernel/ap.cpp:52-53``.
- ``cluster_weight_exact_max_order``: ``libms/src/kernel/lg.cpp:362-366``.
- ``path_min_length`` / ``path_min_length_touching``: ``lg.cpp:375,396``.
- ``join_max_distance``: ``lg.cpp:570``.
- ``skip_last_paf_line``: reproduces the reference reader's loop bound
  ``lineIdx < getLineCount() - 1`` (``BlastFileReader.cpp:76``), which
  never parses the final PAF line.  Disable for a fixed-semantics run.
- scrubber/pipeline knobs: ``pipeline/scrubber_bfs.py:19,49,147``,
  ``pipeline/pipeline.sh:29``.
- mapper (minimap2-replacement) knobs mirror the flags the reference
  passes to minimap2 (``pipeline/pipeline.sh:163``: ``-k15 -w5 -m100``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path


@dataclass(frozen=True)
class GraphConfig:
    """Overlap-graph construction + reduction thresholds."""

    min_matches: int = 400
    th_length: int = 500
    th_matches: int = 500
    th_overlap: int = 100
    wiggle_room: int = 300
    base_weight_multiplicator: float = 1.1
    max_weight_multiplicator: float = 0.8
    skip_last_paf_line: bool = True


@dataclass(frozen=True)
class LinearizeConfig:
    """Path-extraction (linearization) tunables."""

    cluster_weight_exact_max_order: int = 150_000
    path_min_length: int = 10
    path_min_length_touching: int = 5
    join_max_distance: int = 3


@dataclass(frozen=True)
class ConsensusConfig:
    """Consensus emission tunables."""

    th_sequence_length: int = 200
    sequence_line_length: int = 60


@dataclass(frozen=True)
class MapperConfig:
    """Device minimizer seeding + chaining (minimap2-stage replacement)."""

    k: int = 15
    w: int = 5
    min_chain_score: int = 100
    max_gap: int = 10_000
    bandwidth: int = 2_000
    min_anchor_count: int = 3
    max_occ: int = 64
    # alignment-refined match counts (the reference's `-c --eqx` stage):
    # run the banded-DP kernel over every mapped region
    refine: bool = False
    refine_band: int = 256


@dataclass(frozen=True)
class ScrubConfig:
    """Read scrubbing (pipeline stage ④ replacement)."""

    subset_size: int = 60_000
    min_hit_length: int = 500
    end_trim: int = 200
    ext_merge_distance: int = 500


@dataclass(frozen=True)
class PipelineConfig:
    """Full-pipeline orchestration knobs."""

    min_unitig_length: int = 500
    kmer_k_filter: int = 25
    kmer_iqr_multiplier: float = 2.0
    unitig_iqr_multiplier: float = 1.5


# A gate threshold above any count: the phase stays on the host on a card
# (on the CPU the gates always open, as in the JAX package); 0 forces it.
GATE_CLOSED = 1 << 62


@dataclass(frozen=True)
class DeviceConfig:
    """Execution-placement knobs of the port's device phases.

    The three size thresholds were measured on an NVIDIA H100 80GB HBM3 at
    a 700.00 W power limit by ``scripts/torch_gate_crossover.py``: the
    core's simulator at 15x, whole assemblies at 0.05-4.6 Mb and phase ②
    alone at 4.6-140 Mb, each arm in fresh processes; ``min_device_batch``
    on buckets whose problems hold the anchors the driver bins into them.
    """

    # Edges whose anchor count is <= this run through the fused device DP;
    # the kernel's K (its padding), K <= 128.
    chain_buckets: tuple[int, ...] = (8, 16, 32, 64, 128)
    # Minimum problems in a bucket before it goes to the device; a smaller
    # bucket runs the host oracle's DP.  The largest per-bucket crossover of
    # the card's pack, copies, chain_dp and reconstruction against the host
    # DP, over five draws: K = 8 (problems of 1-8 anchors, as a 4.6 Mb core
    # holds) from 16 problems, K = 16 to 128 from 1.
    min_device_batch: int = 16
    # Minimum 2 x graph.size (an upper bound on the (edge, strand class)
    # problems) before phase ③ chaining runs on the device; 0 forces it.
    # The card's chaining stage beat the host oracle's at every size
    # measured, so this is the smallest count measured (2,348 at 0.05 Mb,
    # rounded down); the crossover lies below it.
    chain_device_min_problems: int = 2_300
    # Minimum match-table rows before phase ② edges runs on the device.
    # The card's edges stage lost to the host's at every size measured,
    # 572 to 1,615,619 rows (0.05-140 Mb): no crossover was found, so the
    # gate stays closed on a card and the device edges run only when forced
    # (0).
    edges_device_min_rows: int = GATE_CLOSED
    # Data-parallel mesh axis name for read streaming.
    data_axis: str = "reads"
    use_device: bool = True


@dataclass(frozen=True)
class Config:
    graph: GraphConfig = field(default_factory=GraphConfig)
    linearize: LinearizeConfig = field(default_factory=LinearizeConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    mapper: MapperConfig = field(default_factory=MapperConfig)
    scrub: ScrubConfig = field(default_factory=ScrubConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "Config":
        raw = json.loads(text)

        def build(cls, data):
            kwargs = {}
            for f in dataclasses.fields(cls):
                if f.name not in data:
                    continue
                value = data[f.name]
                if dataclasses.is_dataclass(f.type) or f.name in _SECTIONS:
                    value = build(_SECTIONS[f.name], value)
                elif isinstance(value, list):
                    value = tuple(value)
                kwargs[f.name] = value
            return cls(**kwargs)

        return build(Config, raw)

    @staticmethod
    def load(path: str | Path) -> "Config":
        return Config.from_json(Path(path).read_text())

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())


_SECTIONS = {
    "graph": GraphConfig,
    "linearize": LinearizeConfig,
    "consensus": ConsensusConfig,
    "mapper": MapperConfig,
    "scrub": ScrubConfig,
    "pipeline": PipelineConfig,
    "device": DeviceConfig,
}

DEFAULT_CONFIG = Config()
