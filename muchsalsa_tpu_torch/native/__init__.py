"""Native (C++) host runtime loaded through ctypes.

Provides accelerated PAF parsing + string interning, FASTA/FASTQ
parsing, and reverse complement — the data plane the reference
implements in ``libms`` C++.  Auto-builds the shared library with g++
on first import; all callers fall back to the pure-Python paths when
the toolchain or library is unavailable (``native.available()``).

The port's copy of ``muchsalsa_tpu/native``.  The library builds into
``build/muchsalsa_tpu_torch/`` at the root of the checkout, named by a hash
of its source, under a private name renamed into place, so concurrent
first uses never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "ms_native.cpp"
_BUILD_DIR = _HERE.parent.parent / "build" / "muchsalsa_tpu_torch"
_LIB = _BUILD_DIR / f"libms_native_{hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]}.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> bool:
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
            out = Path(tmp) / _LIB.name
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                 "-pthread", str(_SRC), "-o", str(out)],
                check=True,
                capture_output=True,
                timeout=300,
            )
            os.replace(out, _LIB)
        return True
    except Exception:
        return False


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("MS_TPU_NO_NATIVE"):
            return None
        if not _LIB.exists():
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            return None

        i64, i32, u8p = ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)
        charp = ctypes.c_char_p
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)

        lib.ms_revcomp.argtypes = [u8p, u8p, i64]
        lib.ms_parse_paf.argtypes = [
            charp, i64, i32, i32,
            i32p, i32p, i32p, i32p, i32p, i32p, i32p, u8p, i64p, i64p, i64,
        ]
        lib.ms_parse_paf.restype = i64
        lib.ms_paf_count_lines.argtypes = [charp, i64]
        lib.ms_paf_count_lines.restype = i64
        lib.ms_paf_nano_names.restype = charp
        lib.ms_paf_illu_names.restype = charp
        lib.ms_parse_fasta.argtypes = [charp, i64, i32]
        lib.ms_parse_fasta.restype = i64
        lib.ms_fasta_seq_len.restype = i64
        lib.ms_fasta_names_len.restype = i64
        lib.ms_fasta_copy.argtypes = [u8p, i64p, ctypes.c_char_p]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.ms_pack_reads_2bit.argtypes = [
            u8p, i64p, i64, i64, u32p, u32p, i32p,
        ]

        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def revcomp(seq: bytes) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(seq)
    out = np.empty(n, dtype=np.uint8)
    inp = np.frombuffer(seq, dtype=np.uint8)
    lib.ms_revcomp(
        inp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
    )
    return out.tobytes()


def parse_paf(data: bytes, min_matches: int, skip_last: bool):
    """Returns dict of arrays + (nano_names, illu_names) or None."""
    lib = _load()
    if lib is None:
        return None
    n_lines = lib.ms_paf_count_lines(data, len(data))
    cap = max(int(n_lines), 1)

    def a32():
        return np.zeros(cap, dtype=np.int32)

    illu_id, nano_id = a32(), a32()
    illu_start, illu_end = a32(), a32()
    nano_start, nano_end, nano_length = a32(), a32(), a32()
    direction = np.zeros(cap, dtype=np.uint8)
    score = np.zeros(cap, dtype=np.int64)
    line_idx = np.zeros(cap, dtype=np.int64)

    def p32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    def p64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    n = lib.ms_parse_paf(
        data, len(data), min_matches, 1 if skip_last else 0,
        p32(illu_id), p32(nano_id), p32(illu_start), p32(illu_end),
        p32(nano_start), p32(nano_end), p32(nano_length),
        direction.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        p64(score), p64(line_idx), cap,
    )
    if n < 0:
        lib.ms_paf_free()
        raise ValueError("Invalid PAF: fewer than 10 columns on some line")

    nano_names = lib.ms_paf_nano_names().decode()
    illu_names = lib.ms_paf_illu_names().decode()
    lib.ms_paf_free()

    sl = slice(0, n)
    return (
        {
            "illu_id": illu_id[sl].copy(),
            "nano_id": nano_id[sl].copy(),
            "illu_start": illu_start[sl].copy(),
            "illu_end": illu_end[sl].copy(),
            "nano_start": nano_start[sl].copy(),
            "nano_end": nano_end[sl].copy(),
            "nano_length": nano_length[sl].copy(),
            "direction": direction[sl].astype(bool),
            "score": score[sl].copy(),
            "line_idx": line_idx[sl].copy(),
        },
        nano_names.split("\n") if nano_names else [],
        illu_names.split("\n") if illu_names else [],
    )


def parse_fasta(data: bytes, is_fastq: bool):
    """Returns (names, seq_blob, offsets) or None."""
    lib = _load()
    if lib is None:
        return None
    n = lib.ms_parse_fasta(data, len(data), 1 if is_fastq else 0)
    if n == 0:
        lib.ms_fasta_free()
        return [], b"", np.zeros(1, dtype=np.int64)
    seq_len = lib.ms_fasta_seq_len()
    names_len = lib.ms_fasta_names_len()
    seq = np.empty(int(seq_len), dtype=np.uint8)
    offsets = np.empty(int(n) + 1, dtype=np.int64)
    names_buf = ctypes.create_string_buffer(int(names_len))
    lib.ms_fasta_copy(
        seq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        names_buf,
    )
    lib.ms_fasta_free()
    names = names_buf.raw[: int(names_len)].decode().split("\n")
    return names, seq.tobytes(), offsets


def _setup_mapper(lib):
    import ctypes as ct

    u8p = ct.POINTER(ct.c_uint8)
    i32p = ct.POINTER(ct.c_int32)
    i64p = ct.POINTER(ct.c_int64)
    u32p = ct.POINTER(ct.c_uint32)
    lib.ms_minimizers.argtypes = [u8p, ct.c_int64, ct.c_int32, ct.c_int32,
                                  i32p, u32p, u8p]
    lib.ms_minimizers.restype = ct.c_int64
    lib.ms_map_read.argtypes = [
        u8p, ct.c_int64, ct.c_int32, ct.c_int32,
        u32p, ct.c_int64, i64p, i32p, i32p, u8p,
        ct.c_int32, ct.c_int32, ct.c_int32,
        i32p, u8p, i32p, i32p, i32p, i32p, i32p, i32p, ct.c_int64,
    ]
    lib.ms_map_read.restype = ct.c_int64
    lib.ms_map_batch.argtypes = [
        u8p, i64p, ct.c_int64, ct.c_int32, ct.c_int32,
        u32p, ct.c_int64, i64p, i32p, i32p, u8p,
        ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32,
    ]
    lib.ms_map_batch.restype = ct.c_int64
    lib.ms_map_batch_copy.argtypes = [
        i32p, i32p, u8p, i32p, i32p, i32p, i32p, i32p, i32p,
    ]
    lib.ms_sketch_batch.argtypes = [
        u8p, i64p, ct.c_int64, ct.c_int32, ct.c_int32, ct.c_int32,
    ]
    lib.ms_sketch_batch.restype = ct.c_int64
    lib.ms_sketch_batch_copy.argtypes = [i64p, i32p, u32p, u8p]


def _p(a, typ):
    import ctypes as ct

    return a.ctypes.data_as(ct.POINTER(typ))


def minimizers_native(codes: np.ndarray, k: int, w: int):
    """Native minimizer sketch; returns (pos, hash, strand) arrays."""
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib, "_mapper_ready"):
        _setup_mapper(lib)
        lib._mapper_ready = True
    import ctypes as ct

    n = len(codes)
    pos = np.empty(max(n, 1), dtype=np.int32)
    h = np.empty(max(n, 1), dtype=np.uint32)
    strand = np.empty(max(n, 1), dtype=np.uint8)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    cnt = lib.ms_minimizers(
        _p(codes, ct.c_uint8), n, k, w,
        _p(pos, ct.c_int32), _p(h, ct.c_uint32), _p(strand, ct.c_uint8),
    )
    return pos[:cnt].copy(), h[:cnt].copy(), strand[:cnt].astype(bool)


def map_read_native(codes, k, w, idx_hashes, idx_offsets, entry_unitig,
                    entry_pos, entry_strand, bandwidth, min_anchors, min_chain,
                    max_out=4096):
    """Native map_read core; returns dict of result arrays or None."""
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib, "_mapper_ready"):
        _setup_mapper(lib)
        lib._mapper_ready = True
    import ctypes as ct

    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    out = {
        "unitig": np.empty(max_out, np.int32),
        "strand": np.empty(max_out, np.uint8),
        "qs": np.empty(max_out, np.int32),
        "qe": np.empty(max_out, np.int32),
        "ts": np.empty(max_out, np.int32),
        "te": np.empty(max_out, np.int32),
        "matches": np.empty(max_out, np.int32),
        "n_anchors": np.empty(max_out, np.int32),
    }
    n = lib.ms_map_read(
        _p(codes, ct.c_uint8), len(codes), k, w,
        _p(idx_hashes, ct.c_uint32), len(idx_hashes),
        _p(idx_offsets, ct.c_int64), _p(entry_unitig, ct.c_int32),
        _p(entry_pos, ct.c_int32),
        _p(entry_strand.view(np.uint8), ct.c_uint8),
        bandwidth, min_anchors, min_chain,
        _p(out["unitig"], ct.c_int32), _p(out["strand"], ct.c_uint8),
        _p(out["qs"], ct.c_int32), _p(out["qe"], ct.c_int32),
        _p(out["ts"], ct.c_int32), _p(out["te"], ct.c_int32),
        _p(out["matches"], ct.c_int32), _p(out["n_anchors"], ct.c_int32),
        max_out,
    )
    return {key: arr[:n] for key, arr in out.items()}


def _blob_offsets(seqs: list[bytes]):
    """Concatenate ASCII sequences into (blob array, int64 offsets)."""
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    blob = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    if len(blob) == 0:
        blob = np.zeros(1, dtype=np.uint8)
    return blob, offsets


def map_batch_native(seqs: list[bytes], k, w, idx_hashes, idx_offsets,
                     entry_unitig, entry_pos, entry_strand,
                     bandwidth, min_anchors, min_chain, threads=0):
    """Map every sequence against the index in one multithreaded native
    call.  Returns a dict of per-hit arrays (``read`` = index into
    ``seqs``) or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib, "_mapper_ready"):
        _setup_mapper(lib)
        lib._mapper_ready = True
    import ctypes as ct

    blob, offsets = _blob_offsets(seqs)
    total = lib.ms_map_batch(
        _p(blob, ct.c_uint8), _p(offsets, ct.c_int64), len(seqs), k, w,
        _p(idx_hashes, ct.c_uint32), len(idx_hashes),
        _p(idx_offsets, ct.c_int64), _p(entry_unitig, ct.c_int32),
        _p(entry_pos, ct.c_int32), _p(entry_strand.view(np.uint8), ct.c_uint8),
        bandwidth, min_anchors, min_chain, threads,
    )
    n = max(int(total), 1)
    out = {
        "read": np.empty(n, np.int32),
        "unitig": np.empty(n, np.int32),
        "strand": np.empty(n, np.uint8),
        "qs": np.empty(n, np.int32),
        "qe": np.empty(n, np.int32),
        "ts": np.empty(n, np.int32),
        "te": np.empty(n, np.int32),
        "matches": np.empty(n, np.int32),
        "n_anchors": np.empty(n, np.int32),
    }
    lib.ms_map_batch_copy(
        _p(out["read"], ct.c_int32), _p(out["unitig"], ct.c_int32),
        _p(out["strand"], ct.c_uint8), _p(out["qs"], ct.c_int32),
        _p(out["qe"], ct.c_int32), _p(out["ts"], ct.c_int32),
        _p(out["te"], ct.c_int32), _p(out["matches"], ct.c_int32),
        _p(out["n_anchors"], ct.c_int32),
    )
    lib.ms_map_batch_free()
    return {key: arr[: int(total)] for key, arr in out.items()}


def sketch_batch_native(seqs: list[bytes], k, w, threads=0):
    """Minimizer sketches of every sequence in one multithreaded call.
    Returns (read_offsets[n+1], pos, hash, strand) or None."""
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib, "_mapper_ready"):
        _setup_mapper(lib)
        lib._mapper_ready = True
    import ctypes as ct

    blob, offsets = _blob_offsets(seqs)
    total = lib.ms_sketch_batch(
        _p(blob, ct.c_uint8), _p(offsets, ct.c_int64), len(seqs), k, w, threads
    )
    n = max(int(total), 1)
    read_offsets = np.empty(len(seqs) + 1, dtype=np.int64)
    pos = np.empty(n, np.int32)
    h = np.empty(n, np.uint32)
    strand = np.empty(n, np.uint8)
    lib.ms_sketch_batch_copy(
        _p(read_offsets, ct.c_int64), _p(pos, ct.c_int32),
        _p(h, ct.c_uint32), _p(strand, ct.c_uint8),
    )
    lib.ms_sketch_batch_free()
    t = int(total)
    return read_offsets, pos[:t], h[:t], strand[:t].astype(bool)


def _setup_kmer(lib):
    import ctypes as ct

    u8p = ct.POINTER(ct.c_uint8)
    u64p = ct.POINTER(ct.c_uint64)
    i64p = ct.POINTER(ct.c_int64)
    lib.ms_count_kmers.argtypes = [u8p, i64p, ct.c_int64, ct.c_int32, ct.c_int32]
    lib.ms_count_kmers.restype = ct.c_int64
    lib.ms_count_kmers_copy.argtypes = [u64p, i64p]
    lib.ms_filter_pairs.argtypes = [
        u8p, i64p, u8p, i64p, ct.c_int64, ct.c_int32,
        u64p, ct.c_int64, u8p, ct.c_int32,
    ]
    lib.ms_build_unitigs.argtypes = [u64p, ct.c_int64, ct.c_int32, ct.c_int32]
    lib.ms_build_unitigs.restype = ct.c_int64
    lib.ms_build_unitigs_from_ext.argtypes = [
        u64p, ct.c_int64, ct.c_int32, ct.POINTER(ct.c_int32), ct.c_int32]
    lib.ms_build_unitigs_from_ext.restype = ct.c_int64
    lib.ms_unitigs_blob_len.restype = ct.c_int64
    lib.ms_unitigs_copy.argtypes = [u8p, i64p]


def _kmer_lib():
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib, "_kmer_ready"):
        _setup_kmer(lib)
        lib._kmer_ready = True
    return lib


def count_kmers_native(seqs: list[bytes], k: int, threads=0):
    """Sorted unique canonical k-mers + counts in one multithreaded
    call (jellyfish-count equivalent), or None."""
    lib = _kmer_lib()
    if lib is None:
        return None
    import ctypes as ct

    blob, offsets = _blob_offsets(seqs)
    n = lib.ms_count_kmers(
        _p(blob, ct.c_uint8), _p(offsets, ct.c_int64), len(seqs), k, threads
    )
    vals = np.empty(max(int(n), 1), np.uint64)
    counts = np.empty(max(int(n), 1), np.int64)
    lib.ms_count_kmers_copy(_p(vals, ct.c_uint64), _p(counts, ct.c_int64))
    lib.ms_count_kmers_free()
    return vals[: int(n)], counts[: int(n)]


def filter_pairs_native(pairs, bad_sorted: np.ndarray, k: int, threads=0):
    """Keep-mask over read pairs (bbduk hdist=0 equivalent), or None."""
    lib = _kmer_lib()
    if lib is None:
        return None
    import ctypes as ct

    blob1, off1 = _blob_offsets([a for a, _ in pairs])
    blob2, off2 = _blob_offsets([b for _, b in pairs])
    bad = np.ascontiguousarray(bad_sorted, dtype=np.uint64)
    if len(bad) == 0:
        bad = np.zeros(1, dtype=np.uint64)
    keep = np.zeros(len(pairs), dtype=np.uint8)
    lib.ms_filter_pairs(
        _p(blob1, ct.c_uint8), _p(off1, ct.c_int64),
        _p(blob2, ct.c_uint8), _p(off2, ct.c_int64),
        len(pairs), k, _p(bad, ct.c_uint64), len(bad_sorted),
        _p(keep, ct.c_uint8), threads,
    )
    return keep.astype(bool)


def build_unitigs_native(kmers_sorted: np.ndarray, k: int, min_length: int):
    """Maximal non-branching de Bruijn paths (abyss equivalent), or None."""
    lib = _kmer_lib()
    if lib is None:
        return None
    import ctypes as ct

    km = np.ascontiguousarray(kmers_sorted, dtype=np.uint64)
    if len(km) == 0:
        return []
    n = int(lib.ms_build_unitigs(_p(km, ct.c_uint64), len(km), k, min_length))
    blob_len = int(lib.ms_unitigs_blob_len())
    blob = np.empty(max(blob_len, 1), np.uint8)
    offsets = np.empty(n + 1, np.int64)
    lib.ms_unitigs_copy(_p(blob, ct.c_uint8), _p(offsets, ct.c_int64))
    lib.ms_unitigs_free()
    raw = blob.tobytes()
    return [raw[offsets[i]:offsets[i + 1]] for i in range(n)]


def build_unitigs_from_ext_native(kmers_sorted: np.ndarray, k: int,
                                  ext: np.ndarray, min_length: int):
    """The DBG stitch driven by a precomputed (N, 8) extension-index
    table (the device leg, ops/dbg_jax.py), or None.  Identical output
    to build_unitigs_native."""
    lib = _kmer_lib()
    if lib is None:
        return None
    import ctypes as ct

    km = np.ascontiguousarray(kmers_sorted, dtype=np.uint64)
    if len(km) == 0:
        return []
    ex = np.ascontiguousarray(ext, dtype=np.int32)
    assert ex.shape == (len(km), 8)
    n = int(lib.ms_build_unitigs_from_ext(
        _p(km, ct.c_uint64), len(km), k, _p(ex, ct.c_int32), min_length))
    blob_len = int(lib.ms_unitigs_blob_len())
    blob = np.empty(max(blob_len, 1), np.uint8)
    offsets = np.empty(n + 1, np.int64)
    lib.ms_unitigs_copy(_p(blob, ct.c_uint8), _p(offsets, ct.c_int64))
    lib.ms_unitigs_free()
    raw = blob.tobytes()
    return [raw[offsets[i]:offsets[i + 1]] for i in range(n)]


def build_index_native(seqs: list[bytes], ids: np.ndarray, k: int, w: int,
                       max_occ: int, threads=0):
    """Build the whole minimizer index (sorted unique hashes + CSR
    entries, repeat-masked) in one multithreaded call, byte-identical
    to MinimizerIndex.build's python path.  Returns
    (hashes, offsets, unitig, pos, strand) or None."""
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib, "_index_ready"):
        import ctypes as ct

        u8p = ct.POINTER(ct.c_uint8)
        i32p = ct.POINTER(ct.c_int32)
        i64p = ct.POINTER(ct.c_int64)
        u32p = ct.POINTER(ct.c_uint32)
        lib.ms_build_index.argtypes = [
            u8p, i64p, ct.c_int64, i32p, ct.c_int32, ct.c_int32,
            ct.c_int64, ct.c_int32,
        ]
        lib.ms_build_index.restype = ct.c_int64
        lib.ms_index_entries.restype = ct.c_int64
        lib.ms_index_copy.argtypes = [u32p, i64p, i32p, i32p, u8p]
        lib._index_ready = True
    import ctypes as ct

    blob, offsets = _blob_offsets(seqs)
    ids32 = np.ascontiguousarray(ids, dtype=np.int32)
    n_uniq = int(lib.ms_build_index(
        _p(blob, ct.c_uint8), _p(offsets, ct.c_int64), len(seqs),
        _p(ids32, ct.c_int32), k, w, max_occ, threads,
    ))
    n_entries = int(lib.ms_index_entries())
    uniq = np.empty(max(n_uniq, 1), np.uint32)
    offs = np.empty(n_uniq + 1, np.int64)
    unitig = np.empty(max(n_entries, 1), np.int32)
    pos = np.empty(max(n_entries, 1), np.int32)
    strand = np.empty(max(n_entries, 1), np.uint8)
    lib.ms_index_copy(
        _p(uniq, ct.c_uint32), _p(offs, ct.c_int64),
        _p(unitig, ct.c_int32), _p(pos, ct.c_int32), _p(strand, ct.c_uint8),
    )
    lib.ms_index_free()
    return (uniq[:n_uniq], offs, unitig[:n_entries], pos[:n_entries],
            strand[:n_entries].astype(bool))


def pack_reads_2bit(seqs: list[bytes], L: int, n_rows: int | None = None):
    """One-pass ASCII -> (packed, nmask, lens) batch build for the
    device mapper — byte-identical to
    ``pack_codes(encode_2bit(...))`` over a padded (R, L) batch but
    without the ~6 numpy passes (ms_native.cpp::ms_pack_reads_2bit).
    Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None or L % 32:
        return None
    R = n_rows if n_rows is not None else len(seqs)
    blob = b"".join(seqs)
    offs = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offs[1:])
    buf = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, np.uint8)
    packed = np.zeros((R, L // 16), dtype=np.uint32)
    nmask = np.zeros((R, L // 32), dtype=np.uint32)
    lens = np.zeros(R, dtype=np.int32)
    ct = ctypes
    lib.ms_pack_reads_2bit(
        buf.ctypes.data_as(ct.POINTER(ct.c_uint8)),
        offs.ctypes.data_as(ct.POINTER(ct.c_int64)),
        len(seqs), L,
        packed.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        nmask.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        lens.ctypes.data_as(ct.POINTER(ct.c_int32)),
    )
    if R > len(seqs):
        # pad rows: every position decodes to the sentinel 4
        nmask[len(seqs):] = 0xFFFFFFFF
    return packed, nmask, lens
