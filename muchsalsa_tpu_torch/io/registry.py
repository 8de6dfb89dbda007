"""String -> dense-uint id interning.

Equivalent of the reference ``Registry`` (``libms/src/Registry.cpp:36-45``,
``include/ms/Registry.h:46-61``) minus the mutex: ids are assigned in
first-occurrence order, which in this framework is *deterministic*
(single-threaded ingest in file order) — unlike the reference, whose
parallel PAF parsing makes id assignment a race.
"""

from __future__ import annotations


class Registry:
    __slots__ = ("_map", "_names")

    def __init__(self) -> None:
        self._map: dict[str, int] = {}
        self._names: list[str] = []

    def __getitem__(self, key: str) -> int:
        idx = self._map.get(key)
        if idx is None:
            idx = len(self._names)
            self._map[key] = idx
            self._names.append(key)
        return idx

    def get(self, key: str) -> int | None:
        return self._map.get(key)

    def name(self, idx: int) -> str:
        return self._names[idx]

    def __len__(self) -> int:
        return len(self._names)

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def names(self) -> list[str]:
        return list(self._names)

    def clear(self) -> None:
        self._map.clear()
        self._names.clear()
