"""Sequence primitives: reverse complement, python-style slicing, line wrap.

Behavioral parity notes (reference ``libms/src/SequenceUtils.cpp``):

- ``str_slice(s, i, j)`` mirrors ``muchsalsa::strSlice`` exactly,
  *including* its inclusive-end arithmetic: the C++ computes
  ``substr(start, end - start + 1)`` with ``end = max(min(size, max(0,j)), i)``,
  so ``str_slice(s, l, r)`` yields the characters ``[l, r]`` *inclusive*
  (negative indices are python-style).  Callers that want the inclusive
  range ``[l, r]`` of a match must pass ``r + 1`` just like the C++ callers
  do (``SequenceUtils.cpp:66,78``) — use :func:`sub_sequence` for that.
- ``reverse_complement`` maps only upper-case ``ACGT``; every other byte
  (including lower case and ``N``) passes through unchanged, matching the
  ``switch`` at ``SequenceUtils.cpp:46-57``.
"""

from __future__ import annotations

import numpy as np

# Identity except A<->T, C<->G (upper case only — see module docstring).
_RC_TABLE = bytearray(range(256))
for _a, _b in ((ord("A"), ord("T")), (ord("G"), ord("C"))):
    _RC_TABLE[_a], _RC_TABLE[_b] = _b, _a
_RC_TABLE = bytes(_RC_TABLE)

_RC_LUT_NP = np.frombuffer(_RC_TABLE, dtype=np.uint8)


def reverse_complement(seq: str | bytes) -> str | bytes:
    """Reverse complement; str in → str out, bytes in → bytes out."""
    if isinstance(seq, str):
        return seq.translate(_RC_TRANS)[::-1]
    return seq.translate(_RC_TABLE)[::-1]


_RC_TRANS = str.maketrans("ATGC", "TACG")


def reverse_complement_u8(arr: np.ndarray) -> np.ndarray:
    """Reverse complement of a uint8 ASCII array (vectorised)."""
    return _RC_LUT_NP[arr][::-1]


def str_slice(s: str | bytes, i: int, j: int) -> str | bytes:
    """Python-port of ``muchsalsa::strSlice`` (SequenceUtils.cpp:27-38)."""
    n = len(s)
    if i < 0:
        i = n + i
    if j < 0:
        j = n + j
    start = max(0, i)
    end = max(min(n, max(0, j)), i)
    return s[start : end + 1]


def sub_sequence(seq: str | bytes, left: int, right: int, direction: bool) -> str | bytes:
    """Inclusive ``[left, right]`` sub-sequence fetch with optional revcomp.

    Mirrors ``muchsalsa::getIlluminaSequence`` / ``getNanoporeSequence``
    (SequenceUtils.cpp:63-85): the C++ passes ``right + 1`` into strSlice,
    whose inclusive-end arithmetic then yields ``[left, right + 1]``.
    That extra trailing base is reproduced here for output parity.
    """
    out = str_slice(seq, left, right + 1)
    if not direction:
        return reverse_complement(out)
    return out


def wrap_sequence(seq: str, width: int = 60) -> str:
    """Split into ``width``-char lines (reference ``limitLength``, ap.cpp:61-76)."""
    if not seq:
        return seq
    return "\n".join(seq[i : i + width] for i in range(0, len(seq), width))


_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[_c + 32] = _i  # lower case


def encode_2bit(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII -> {A:0, C:1, G:2, T:3, other:4} uint8 codes."""
    if isinstance(seq, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(seq, dtype=np.uint8)
    else:
        arr = seq
    return _CODE[arr]


_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def decode_2bit(codes: np.ndarray) -> bytes:
    """Inverse of :func:`encode_2bit` (other -> ``N``)."""
    return _DECODE[codes].tobytes()
