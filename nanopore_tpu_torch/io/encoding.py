"""Base encoding: DNA strings <-> int8 code arrays.

The whole on-device compute path works on int8 base codes:
A=0, C=1, G=2, T=3, everything else (N, ambiguity codes) = 4.

This replaces the reference's per-character Python
string handling (e.g. reverseComplement in sonLib bioio, used throughout
reference nanopore/analyses/utils.py).
"""

from __future__ import annotations

import numpy as np

BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 0, 1, 2, 3, 4
NUM_BASES = 4  # real nucleotides; code 4 is the wildcard bucket
ALPHABET = "ACGTN"

# Lookup tables over all 256 byte values.
_ENCODE_LUT = np.full(256, BASE_N, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    _ENCODE_LUT[ord(_b)] = _i
    _ENCODE_LUT[ord(_b.lower())] = _i

_DECODE_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)

# Complement in code space: A<->T, C<->G, N->N.
_COMP_LUT = np.array([BASE_T, BASE_G, BASE_C, BASE_A, BASE_N], dtype=np.int8)

# Complement over characters (for string-level round trips).
_COMP_CHAR = np.arange(256, dtype=np.uint8)
for _a, _b in [("A", "T"), ("C", "G"), ("a", "t"), ("c", "g")]:
    _COMP_CHAR[ord(_a)] = ord(_b)
    _COMP_CHAR[ord(_b)] = ord(_a)


def encode(seq: str) -> np.ndarray:
    """Encode a DNA string into an int8 code array (A=0,C=1,G=2,T=3,other=4)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _ENCODE_LUT[raw]


def decode(codes: np.ndarray) -> str:
    """Decode an int8 code array back into an upper-case DNA string."""
    codes = np.asarray(codes)
    return _DECODE_LUT[np.clip(codes, 0, 4)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space."""
    return _COMP_LUT[np.asarray(codes)][::-1]


def complement_codes(codes: np.ndarray) -> np.ndarray:
    """Complement (no reversal) in code space."""
    return _COMP_LUT[np.asarray(codes)]


def reverse_complement(seq: str) -> str:
    """Reverse complement of a DNA string, preserving case and N handling.

    Semantics of sonLib bioio ``reverseComplement`` as used by the reference
    (utils.py:2); ambiguity codes map to themselves complemented only for
    ACGT/acgt, all other characters pass through unchanged.
    """
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _COMP_CHAR[raw][::-1].tobytes().decode("ascii")
