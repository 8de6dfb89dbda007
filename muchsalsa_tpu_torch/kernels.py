"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all of
them at once, and the objects are linked into one shared library with a
plain C interface (``extern "C"`` launchers), loaded with ``ctypes``.  The
library is built on first use into ``build/muchsalsa_tpu_torch/`` at the
root of the checkout, named by a hash of the sources, headers and flags, so
an edited source builds anew and an unchanged one is reused.  Nothing is
fetched from outside the checkout; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "muchsalsa_tpu_torch"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS,
    "-std=c++17", "-O3",
    # no a*b+c -> fma contraction: results must stay bit-equal to the plain
    # float64 versions
    "--fmad=false",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        f"nvcc not found (looked in {cuda_home}/bin and on PATH); "
        "the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libms_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of these exact sources exists."""
    global build_log
    lib_path = library_path()
    if lib_path.is_file():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    logs = []
    # private names, then a rename: a concurrent build never sees a
    # half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(_sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        failed = []
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{out}")
        if not failed:
            lib_tmp = Path(tmp) / lib_path.name
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib_tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"nvcc link failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
                              f"{proc.stdout}{proc.stderr}")
        build_log = "".join(logs)
        if failed:
            raise RuntimeError("\n".join(failed))
        os.replace(lib_tmp, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.ms_chain_scan.argtypes = [vp, vp, vp, vp, ci, ci, vp]
            lib.ms_chain_dp.argtypes = [vp] * 5 + [ci] * 3 + [ctypes.c_double, vp]
            lib.ms_myers_full.argtypes = [vp] * 7 + [ctypes.POINTER(ci)] + [ci] * 6 + [vp]
            lib.ms_myers_banded.argtypes = [vp] * 6 + [ci] * 9 + [vp]
            lib.ms_banded_wavefront.argtypes = [vp] * 5 + [ci] * 5 + [vp]
            lib.ms_refine_gather.argtypes = [vp] * 12 + [ci] * 3 + [vp]
            for fn in (lib.ms_chain_scan, lib.ms_chain_dp, lib.ms_myers_full, lib.ms_myers_banded,
                       lib.ms_banded_wavefront, lib.ms_refine_gather):
                fn.restype = ci
            lib.ms_cuda_error_string.argtypes = [ci]
            lib.ms_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.ms_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
