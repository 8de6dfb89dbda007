"""Assembly output writer: query FASTA + synthetic PAF + target FASTA.

Reference counterpart: ``OutputWriter`` (``libms/src/OutputWriter.cpp``),
which appends to ``temp_1.query.fa`` / ``temp_1.align.paf`` /
``temp_1.target.fa`` under three mutexes.  Here paths are writable once
per process; consensus emission is already serialized per-path, so plain
buffered file objects suffice.
"""

from __future__ import annotations

from pathlib import Path


class BufferedOutputWriter:
    """In-memory OutputWriter used by the parallel assembly fan-out:
    each worker collects one path's emission, the parent concatenates
    the buffers in path order (byte-identical to the sequential run)."""

    def __init__(self) -> None:
        self._query: list[str] = []
        self._paf: list[str] = []
        self._target: list[str] = []

    def write_query(self, data: str) -> None:
        self._query.append(data)

    def write_paf(self, data: str) -> None:
        self._paf.append(data)

    def write_target(self, data: str) -> None:
        self._target.append(data)

    def texts(self) -> tuple[str, str, str]:
        return "".join(self._query), "".join(self._paf), "".join(self._target)


class OutputWriter:
    def __init__(self, query_path: str | Path, paf_path: str | Path, target_path: str | Path):
        self._query = open(query_path, "w")
        self._paf = open(paf_path, "w")
        self._target = open(target_path, "w")

    def write_query(self, data: str) -> None:
        self._query.write(data)

    def write_paf(self, data: str) -> None:
        self._paf.write(data)

    def write_target(self, data: str) -> None:
        self._target.write(data)

    def close(self) -> None:
        for fh in (self._query, self._paf, self._target):
            fh.close()

    def __enter__(self) -> "OutputWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
