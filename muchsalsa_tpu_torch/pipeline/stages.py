"""Stage manifests: explicit checkpoint/resume for the pipeline.

The reference's only resume mechanism is implicit — named intermediate
files in the output dir that a user can manually reuse
(``pipeline/pipeline.sh:163-181``, SURVEY.md §5).  Here every stage
records a manifest entry with content hashes of its inputs and outputs;
a rerun skips stages whose inputs are unchanged and whose outputs still
hash correctly.
"""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path
from typing import Callable


def _file_hash(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class StageRunner:
    def __init__(self, outdir: str | Path, verbose: bool = True):
        self.outdir = Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.outdir / "manifest.json"
        self.manifest: dict = {}
        if self.manifest_path.exists():
            try:
                self.manifest = json.loads(self.manifest_path.read_text())
            except json.JSONDecodeError:
                self.manifest = {}
        self.verbose = verbose

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[pipeline] {msg}", flush=True)

    def run(
        self,
        name: str,
        inputs: list[Path],
        outputs: list[Path],
        fn: Callable[[], None],
        params: dict | None = None,
    ) -> None:
        inputs = [Path(p) for p in inputs]
        outputs = [Path(p) for p in outputs]
        key = {
            "inputs": {str(p): _file_hash(p) for p in inputs},
            "params": params or {},
        }

        entry = self.manifest.get(name)
        if entry and entry.get("key") == key:
            out_ok = all(
                Path(p).exists() and _file_hash(Path(p)) == h
                for p, h in entry.get("outputs", {}).items()
            )
            if out_ok:
                self._log(f"{name}: up to date, skipping")
                return

        self._log(f"{name}: running")
        start = time.perf_counter()
        fn()
        elapsed = time.perf_counter() - start
        self.manifest[name] = {
            "key": key,
            "outputs": {str(p): _file_hash(p) for p in outputs if p.exists()},
            "elapsed_s": round(elapsed, 3),
        }
        self.manifest_path.write_text(json.dumps(self.manifest, indent=2))
        self._log(f"{name}: done in {elapsed:.1f}s")
