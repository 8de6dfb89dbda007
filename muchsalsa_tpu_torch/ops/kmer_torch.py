"""Canonical k-mer counting on a torch device.

Port of ``muchsalsa_tpu/ops/kmer_jax.py``, the device twin of
``pipeline/kmer.py::count_kmers`` (jellyfish-count equivalent, reference
``pipeline/pipeline.sh:142-148``): canonical 2k-bit k-mer packing, one sort
per chunk of reads, run-length counts at the run starts; the chunks merge
on the host (a sorted-run combine), so the result is exactly
``count_kmers``'s ``(sorted unique uint64 values, counts)`` for any
chunking.

With k <= 31 a canonical value is below 2**62, so it is one int64 (the JAX
package splits it across two uint32 lanes and sorts on two keys); padding
sorts last as ``SENTINEL``, above every value.  The JAX package ships
each chunk as a fixed (chunk_bases // row_len, row_len) block of padded
rows, which spared XLA its recompiles; short reads (Illumina's 150 bases
in rows of 16,384) made that 99 % padding, and 512 reads a chunk left the
host to merge ~1,500 chunks' runs.  Here a chunk is its fragments joined
end to end, up to ``chunk_bases`` bases, and the merge stays on the device:
the runs of the chunks counted since the last merge are merged into the
one run before them once they hold ``merge_elems`` values and at least as
many as it, so the card holds at most about twice the distinct k-mers or
one group of runs (a 40 Mb genome's 30x Illumina is ~1.0·10^9 windows in
~143 chunks, most of them distinct within their chunk: kept to the end,
they and one merge of them would take most of an 80 GB card).
"""

from __future__ import annotations

import numpy as np
import torch

from muchsalsa_tpu_torch.device import resolve_device
from muchsalsa_tpu_torch.utils.seq import encode_2bit

SENTINEL = torch.iinfo(torch.int64).max

# the last count_kmers_device call: device, chunks, rows, k-mers counted
# (valid positions) and distinct values
KMER_DEVICE_STATS: dict = {}

Tensor = torch.Tensor


def kmer_values_batch(codes: Tensor, lens: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Canonical k-mer values of a padded read batch.

    ``codes``: (R, L) uint8 codes (A C G T = 0..3, pad and N = 4);
    ``lens``: (R,) int32.  Returns (values (R, L - k + 1) int64, valid
    bool): a position is valid when its k codes are all below 4 and
    ``pos + k <= lens``.  Values equal ``pipeline.kmer.kmer_values64``.
    """
    if not 1 <= k <= 31:
        raise ValueError(f"k = {k}: the int64 packing holds k <= 31")
    R, L = codes.shape
    Lk = max(L - k + 1, 0)
    c = codes.to(torch.int64)
    fwd = torch.zeros((R, Lk), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    bad = torch.zeros((R, Lk), dtype=torch.int32, device=codes.device)
    for j in range(k):
        col = c[:, j : j + Lk]
        fwd = (fwd << 2) | (col & 3)
        rc = rc | (((3 - col) & 3) << (2 * j))
        bad += col >= 4
    pos = torch.arange(Lk, device=codes.device)[None, :]
    valid = (bad == 0) & (pos + k <= lens.to(torch.int64)[:, None])
    return torch.minimum(fwd, rc), valid


def sort_count_chunk(values: Tensor, valid: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Sort one chunk's canonical k-mers and attach run-length counts.

    Returns (sorted values, counts, first, n_valid): flat (N,) tensors where
    ``first`` marks the first slot of each distinct value and ``counts``
    holds each slot's run length; padding sorts to the end as ``SENTINEL``
    and ``n_valid`` (a 0-d tensor) cuts it off.
    """
    keys = torch.where(valid, values, SENTINEL).reshape(-1)
    n_valid = valid.sum()
    sorted_vals = torch.sort(keys).values
    first = torch.ones_like(sorted_vals, dtype=torch.bool)
    first[1:] = sorted_vals[1:] != sorted_vals[:-1]
    run_id = torch.cumsum(first, 0) - 1
    counts = torch.bincount(run_id, minlength=sorted_vals.numel())[run_id]
    return sorted_vals, counts, first, n_valid


def merge_runs(vals: list[Tensor], counts: list[Tensor]) -> tuple[Tensor, Tensor]:
    """One run of several: each run's values sorted and distinct, with
    their counts; returns the sorted distinct values of all of them and the
    counts summed a value (a stable sort, then sums over each value's
    slots)."""
    v, order = torch.sort(torch.cat(vals), stable=True)
    c = torch.cat(counts)[order]
    del order
    first = torch.ones_like(v, dtype=torch.bool)
    first[1:] = v[1:] != v[:-1]
    starts = torch.nonzero(first).squeeze(1)
    del first
    ends = torch.cat([starts[1:], starts.new_tensor([len(v)])])
    total = torch.cumsum(c, 0)
    del c
    merged = total[ends - 1] - torch.where(starts > 0, total[starts - 1], 0)
    return v[starts], merged


def count_kmers_device(
    seqs, k: int, chunk_bases: int = 8 << 20, row_len: int = 1 << 14,
    device: str | torch.device = "cuda", merge_elems: int = 1 << 26,
) -> tuple[np.ndarray, np.ndarray]:
    """``count_kmers`` on ``device``: identical (sorted unique uint64,
    int64 counts).

    Sequences are cut into fragments of ``row_len`` bases, ``k - 1`` bases
    of overlap between a long sequence's fragments so that no boundary
    k-mer is lost or counted twice (the JAX package's loop).  A chunk is
    its fragments joined by one N each, up to ``chunk_bases`` bases: one
    2-bit encoding and one pinned copy a chunk, and a window that spans a
    join holds the N and is invalid, as one past a fragment's end.  Each
    chunk is counted on the device; the chunks' runs merge there
    (``merge_runs``) in groups of at least ``merge_elems`` values and at
    the end, and only the result comes back.
    """
    dev = resolve_device(device)
    step = row_len - (k - 1)
    capacity = max(chunk_bases, row_len)
    stage = torch.empty(capacity, dtype=torch.uint8, pin_memory=dev.type == "cuda")
    stage_np = stage.numpy()

    uniq_chunks: list[Tensor] = []
    count_chunks: list[Tensor] = []
    frags: list[bytes] = []
    stats = {"device": str(dev), "chunks": 0, "rows": 0, "kmers": 0, "merges": 0}
    used = 0
    merged = 0   # values in the run of the last merge, uniq_chunks[0]
    pending = 0  # values in the chunks' runs after it

    def flush():
        nonlocal used, merged, pending
        if not frags:
            return
        joined = encode_2bit(b"N".join(frags))
        n_codes = len(joined)
        stage_np[:n_codes] = joined
        codes = stage[:n_codes].to(dev, non_blocking=True)[None, :]
        lens = torch.full((1,), n_codes, dtype=torch.int32, device=dev)
        sorted_vals, counts, first, n_valid = sort_count_chunk(
            *kmer_values_batch(codes, lens, k))
        # the sync below also ends the copy, so the stage may be refilled
        n = int(n_valid)
        keep = first[:n]
        uniq_chunks.append(sorted_vals[:n][keep])
        count_chunks.append(counts[:n][keep])
        del sorted_vals, counts, first, keep
        pending += len(uniq_chunks[-1])
        if pending >= max(merge_elems, merged) and len(uniq_chunks) > 1:
            run = merge_runs(uniq_chunks, count_chunks)
            uniq_chunks[:], count_chunks[:] = [run[0]], [run[1]]
            merged, pending = len(run[0]), 0
            stats["merges"] += 1
        stats["chunks"] += 1
        stats["rows"] += len(frags)
        stats["kmers"] += n
        frags.clear()
        used = 0

    for seq in seqs:
        # split long sequences into overlapping fragments
        for s in range(0, max(len(seq) - k + 1, 1), step):
            frag = seq[s : s + row_len]
            if len(frag) < k:
                continue
            if frags and used + 1 + len(frag) > capacity:
                flush()
            used += len(frag) + (1 if frags else 0)
            frags.append(frag)
    flush()
    KMER_DEVICE_STATS.clear()
    KMER_DEVICE_STATS.update(stats)

    if not uniq_chunks:
        KMER_DEVICE_STATS["distinct"] = 0
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.int64)
    vals, counts = merge_runs(uniq_chunks, count_chunks)
    del uniq_chunks[:], count_chunks[:]
    KMER_DEVICE_STATS["distinct"] = len(vals)
    return vals.cpu().numpy().astype(np.uint64), counts.cpu().numpy()
