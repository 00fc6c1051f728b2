"""ctypes bindings for the native seed/chain runtime (seedchain.cpp).

Builds ``libseedchain.so`` with the system C++ compiler on first use,
into the package's gitignored ``_build/`` directory.  Seeding, chaining
and the EM flank corridor always run here: a failed build or load raises.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger("nanopore_tpu_torch")

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "seedchain.cpp")
_SO = os.path.join(_PKG_DIR, "_build", "libseedchain.so")

_lock = threading.Lock()
_lib = None


def _build() -> None:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = "%s.%d.tmp" % (_SO, os.getpid())
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        _SRC, "-o", tmp,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(
            "seedchain build failed (%s):\n%s" % (" ".join(cmd), proc.stderr)
        )
    os.replace(tmp, _SO)


def get_lib():
    """The loaded native library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or (
            os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            _build()
        lib = ctypes.CDLL(_SO)
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.seedchain_build_index.restype = ctypes.c_int64
        lib.seedchain_build_index.argtypes = [
            i8p, ctypes.c_int64, ctypes.c_int32, i64p, i32p,
        ]
        lib.seedchain_mask_repeats.restype = ctypes.c_int64
        lib.seedchain_mask_repeats.argtypes = [
            i64p, i32p, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.seedchain_lookup.restype = ctypes.c_int64
        lib.seedchain_lookup.argtypes = [
            i64p, i32p, ctypes.c_int64, i8p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, i32p, i32p,
        ]
        lib.seedchain_chain_dp.restype = None
        lib.seedchain_chain_dp.argtypes = [
            i32p, i32p, i32p, i32p, f64p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
            ctypes.c_double, f64p, i64p,
        ]
        lib.seedchain_flank_corridor.restype = ctypes.c_int
        lib.seedchain_flank_corridor.argtypes = [
            i8p, ctypes.c_int64, f64p, f64p, f64p, f64p, f64p, f64p,
        ]
        _lib = lib
        logger.info("native seedchain runtime loaded: %s", _SO)
    return _lib


# ------------------------------------------------------------------ #
# High-level wrappers (numpy in / numpy out)
# ------------------------------------------------------------------ #
def build_index(codes: np.ndarray, k: int):
    lib = get_lib()
    codes = np.ascontiguousarray(codes, np.int8)
    cap = max(len(codes) - k + 1, 0)
    kmers = np.empty(cap, np.int64)
    positions = np.empty(cap, np.int32)
    n = lib.seedchain_build_index(codes, len(codes), k, kmers, positions)
    return kmers[:n], positions[:n]


def mask_repeats(kmers: np.ndarray, positions: np.ndarray, max_occ: int):
    lib = get_lib()
    kmers = np.ascontiguousarray(kmers, np.int64)
    positions = np.ascontiguousarray(positions, np.int32)
    n = lib.seedchain_mask_repeats(kmers, positions, len(kmers), max_occ)
    return kmers[:n].copy(), positions[:n].copy()


def lookup(sorted_kmers, sorted_positions, read_codes, k,
           capacity: int | None = None, stride: int = 1):
    lib = get_lib()
    sorted_kmers = np.ascontiguousarray(sorted_kmers, np.int64)
    sorted_positions = np.ascontiguousarray(sorted_positions, np.int32)
    read_codes = np.ascontiguousarray(read_codes, np.int8)
    if capacity is None:
        capacity = max(len(read_codes) * 64, 1 << 16)
    ref_pos = np.empty(capacity, np.int32)
    read_pos = np.empty(capacity, np.int32)
    n = lib.seedchain_lookup(
        sorted_kmers, sorted_positions, len(sorted_kmers), read_codes,
        len(read_codes), k, stride, capacity, ref_pos, read_pos,
    )
    return ref_pos[:n].copy(), read_pos[:n].copy()


def chain_dp(q_start, q_end, r_start, r_end, lengths, max_ref_gap,
             max_diag_drift, gap_open, gap_scale):
    lib = get_lib()
    q_start = np.ascontiguousarray(q_start, np.int32)
    q_end = np.ascontiguousarray(q_end, np.int32)
    r_start = np.ascontiguousarray(r_start, np.int32)
    r_end = np.ascontiguousarray(r_end, np.int32)
    lengths = np.ascontiguousarray(lengths, np.float64)
    n = len(q_start)
    score = np.empty(n, np.float64)
    parent = np.empty(n, np.int64)
    lib.seedchain_chain_dp(
        q_start, q_end, r_start, r_end, lengths, n,
        max_ref_gap, max_diag_drift, gap_open, gap_scale, score, parent,
    )
    return score, parent


def flank_corridor(x, t, eg, entry):
    """Exact pure-deletion corridor EM counts (align.flank).

    Returns (trans (5,5), emis (5,16), logz).  When the corridor mass
    underflows to exact zero (e.g. a zero gap-emission probability for a
    base present in the flank) the result is zero counts and a -inf logz.
    """
    lib = get_lib()
    x = np.ascontiguousarray(x, np.int8)
    t = np.ascontiguousarray(t, np.float64)
    eg = np.ascontiguousarray(eg, np.float64)
    entry = np.ascontiguousarray(entry, np.float64)
    trans = np.zeros(25, np.float64)
    emis = np.zeros(80, np.float64)
    logz = np.zeros(1, np.float64)
    status = lib.seedchain_flank_corridor(
        x, len(x), t, eg, entry, trans, emis, logz
    )
    if status != 0:
        return np.zeros((5, 5)), np.zeros((5, 16)), float("-inf")
    return trans.reshape(5, 5), emis.reshape(5, 16), float(logz[0])
