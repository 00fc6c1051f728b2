"""Walkers: direction codes or Viterbi backpointers -> ops -> cigars.

Counterpart of ``nanopore_tpu/ops/traceback_pallas.py``'s two walkers
and the traceback half of ``nanopore_tpu/ops/mea.py``.

MEA walker (``mea_walk``).  The walk starts at
cell (0, 0) and takes, on each diagonal it visits, the move the
direction code of its cell names (0 diag, 1 del, 2 ins), falling back
to D while reference remains, else I, where the code is 3 or points off
the lattice.  It emits one op code per diagonal (OP_NONE where the path
skipped the diagonal or had ended); ``rle_ops_batch`` run-length encodes
the op rows into global cigars consuming exactly m read and n ref bases.

Viterbi walker (``viterbi_walk``): from cell (m, n) in state
``fstate`` it walks DOWN the diagonals over a backpointer plane of
``ops.viterbi`` (0 where the cell lies outside the band).  On the
diagonal k of its cell it emits the op of the move into that cell (M
for state 0, D for 1 and 3, I for 2 and 4), steps back and takes the
predecessor state.  On the int8 byte plane of a canonical model
(``p = bM + 5 * (tD1 + 2 tI1 + 4 tD2 + 8 tI2)``) that is ``p % 5`` from
the match state, the state itself or match (its from-self bit) from a
gap state; on the int16 full plane of any other model
(``p = sum_s b_s << 3s``) it is ``(p >> 3s) & 7`` from state s.  It
stops at the origin; a walk that does not reach (0, 0) leaves its end
cell in the returned (i, j).

The band offsets the walkers need are integrated from bit 6 of the
packed band codes (``xyc``) already on the device, so no offsets upload
is needed: the MEA walker sums them going up, the Viterbi walker sums
them up to its start diagonal and subtracts them going down.

The kernels (``csrc/traceback.cu``, ``csrc/viterbi_traceback.cu``, the
latter with a walk of each plane) run one warp per read, stage its rows
through shared memory and walk them with one lane; each serves its
path's band widths (the MEA walker ``KERNEL_BAND_WIDTHS``: 32, 64, 128,
256, 384, 512, 768, 1024, 1536 and 2048; the Viterbi walker
``VITERBI_BAND_WIDTHS``: the same to 1024), four reads a block, two
where a row is 256 bytes and one where it is more (the full plane at 256
to 1024, the byte rows at 384 to 2048; the rows above 512 bytes, the
full plane's at 384 and 512 and the bytes at 768 and 1024, in chunks of
64 diagonals, the rows above 1024 bytes, the full plane's at 768 and
1024 and the bytes at 1536 and 2048, in chunks of 32, the others 128).
The plain versions serve any width.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nanopore_tpu_torch.io.sam import CIG
from nanopore_tpu_torch.kernels import build as kb
from nanopore_tpu_torch.ops.pack import KERNEL_BAND_WIDTHS, VITERBI_BAND_WIDTHS

DIR_DIAG, DIR_DEL, DIR_INS, DIR_NONE = 0, 1, 2, 3
OP_M, OP_D, OP_I, OP_NONE = 0, 1, 2, 3
_OP_TO_CIG = {OP_M: CIG.M, OP_D: CIG.D, OP_I: CIG.I}

LAUNCHES = kb.LaunchCounter("traceback")
VIT_LAUNCHES = kb.LaunchCounter("viterbi_traceback")
VIT_FULL_LAUNCHES = kb.LaunchCounter("viterbi_traceback_full")
_SIG = {
    "np_walk_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 2,
    "np_walk_smem": [ctypes.c_int],
}
_VIT_SIG = {
    "np_viterbi_walk_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 3,
    "np_viterbi_walk_attrs": [ctypes.c_int] * 2 + [ctypes.c_void_p],
}


def viterbi_walker_attributes(W: int, full: bool = False) -> dict:
    """The compiled Viterbi walker's registers, local-memory (spill)
    bytes per thread, static and dynamic shared memory per block, and
    threads and reads per block at band width ``W``, walking the full
    plane (``full``) or the byte plane (needs the card: builds the
    kernel)."""
    lib = kb.library("viterbi_traceback", _VIT_SIG)
    vals = (ctypes.c_int * 6)()
    kb.check(lib, lib.np_viterbi_walk_attrs(W, int(full), vals),
             "viterbi_traceback attrs")
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "dynamic_smem", "threads", "reads"), vals))


def walker_shared_memory(W: int) -> dict:
    """Dynamic shared memory a block of each walker kernel built at band
    width ``W`` takes (bytes: 4 reads a block, 2 where a row is 256
    bytes, the full plane at W = 128 and the byte rows at W = 256, 1
    where it is more, the full plane at W = 256 to 1024 and the byte rows
    at W = 384 to 2048; needs the card: builds the kernels).  Above 1024
    only the MEA walker has a build: the Viterbi walkers' entries are
    then absent."""
    out = {"traceback": kb.library("traceback", _SIG).np_walk_smem(W)}
    if W in VITERBI_BAND_WIDTHS:
        out["viterbi_traceback"] = viterbi_walker_attributes(W)[
            "dynamic_smem"]
        out["viterbi_traceback_full"] = viterbi_walker_attributes(
            W, True)["dynamic_smem"]
    return out


def _check_inputs(dirs, xyc, m, n, what="dirs", dtypes=(torch.int8,),
                  widths=KERNEL_BAND_WIDTHS):
    dev = dirs.device
    if dirs.dtype not in dtypes or dirs.dim() != 3 or not dirs.is_contiguous():
        raise ValueError("%s must be a contiguous (B, K1, W) tensor of %s"
                         % (what, " or ".join(map(str, dtypes))))
    B, K1, W = dirs.shape
    if (xyc.device != dev or xyc.dtype != torch.int8
            or tuple(xyc.shape) != (B, K1 - 1, W) or not xyc.is_contiguous()):
        raise ValueError("xyc must be a contiguous (B, K1 - 1, W) int8 "
                         "tensor on %s" % dev)
    for name, t in (("m", m), ("n", n)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("%s must be contiguous int32 on %s" % (name, dev))
        if tuple(t.shape) != (B,):
            raise ValueError("%s must be (B,)" % name)
    if dev.type != "cpu":
        # the kernels stage rows with 16-byte and code words with 4-byte
        # copies
        if W not in widths:
            raise ValueError("the walker kernels serve W in %s, got W=%d"
                             % (widths, W))
        if dirs.data_ptr() % 16 or xyc.data_ptr() % 4:
            raise ValueError("%s must be 16-byte and xyc 4-byte aligned"
                             % what)


def mea_walk(dirs, xyc, m, n) -> torch.Tensor:
    """(B, K1) int8 op codes from (B, K1, W) direction codes.

    ``xyc`` (B, K1 - 1, W) supplies the band deltas (bit 6).  CUDA
    tensors launch the kernel, CPU tensors run the plain walker.
    """
    _check_inputs(dirs, xyc, m, n)
    if dirs.device.type == "cpu":
        return mea_walk_plain(dirs, xyc, m, n)
    B, K1, W = dirs.shape
    ops = torch.empty((B, K1), dtype=torch.int8, device=dirs.device)
    if B == 0:
        return ops
    lib = kb.library("traceback", _SIG)
    with torch.cuda.device(dirs.device):
        rc = lib.np_walk_launch(
            kb.ptr(dirs), kb.ptr(xyc), kb.ptr(m), kb.ptr(n), B, K1 - 1, W,
            kb.ptr(ops), kb.stream_of(dirs),
        )
    kb.check(lib, rc, "traceback")
    LAUNCHES.add()
    return ops


def mea_walk_plain(dirs, xyc, m, n) -> torch.Tensor:
    """The walker in plain PyTorch: vectorised over the batch, one loop
    step per diagonal."""
    B, K1, W = dirs.shape
    dev = dirs.device
    d1 = ((xyc[:, :, 0].to(torch.int32) & 0xFF) >> 6) & 1
    offs = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                      torch.cumsum(d1, dim=1, dtype=torch.int32)], dim=1)
    mm = m.to(torch.int32)
    nn = n.to(torch.int32)
    i = torch.zeros(B, dtype=torch.int32, device=dev)
    j = torch.zeros_like(i)
    nk = torch.zeros_like(i)
    rows = torch.arange(B, device=dev)
    ops = torch.empty((B, K1), dtype=torch.int8, device=dev)
    for k in range(K1):
        active = (nk == k) & ((i < mm) | (j < nn))
        b = j - offs[:, k]
        in_band = (b >= 0) & (b < W)
        d = dirs[rows, k, b.clamp(0, W - 1).long()].to(torch.int32)
        d = torch.where(in_band, d, DIR_NONE)
        can_diag = (d == DIR_DIAG) & (i < mm) & (j < nn)
        can_del = (d == DIR_DEL) & (j < nn)
        can_ins = (d == DIR_INS) & (i < mm)
        fb_del = ~(can_diag | can_del | can_ins) & (j < nn)
        op = torch.where(can_diag, OP_M,
                         torch.where(can_del | fb_del, OP_D, OP_I))
        op = torch.where(active, op, OP_NONE)
        i = i + (active & (op != OP_D)).to(torch.int32)
        j = j + (active & (op != OP_I)).to(torch.int32)
        nk = torch.where(active, i + j, nk)
        ops[:, k] = op.to(torch.int8)
    return ops


def viterbi_walk(bp, xyc, m, n, fstate):
    """Viterbi op codes from a backpointer plane.

    bp (B, K1, W), row k = diagonal k: the int8 byte plane or the int16
    full plane of ``ops.viterbi``; ``xyc`` (B, K1 - 1, W) for the band
    deltas, m / n / fstate (B,) int32.  Returns (ops (B, K1) int8 with
    OP_NONE off the path, end (B, 2) int32: the cell (i, j) where each
    walk stopped, (0, 0) when it reached the origin).  CUDA tensors
    launch the kernel's walk of that plane, CPU tensors run the plain
    walker.
    """
    _check_inputs(bp, xyc, m, n, "bp", (torch.int8, torch.int16),
                  VITERBI_BAND_WIDTHS)
    if (fstate.device != bp.device or fstate.dtype != torch.int32
            or tuple(fstate.shape) != (bp.shape[0],)
            or not fstate.is_contiguous()):
        raise ValueError("fstate must be contiguous (B,) int32 on %s"
                         % bp.device)
    if bp.device.type == "cpu":
        return viterbi_walk_plain(bp, xyc, m, n, fstate)
    B, K1, W = bp.shape
    ops = torch.empty((B, K1), dtype=torch.int8, device=bp.device)
    end = torch.empty((B, 2), dtype=torch.int32, device=bp.device)
    if B == 0:
        return ops, end
    full = bp.dtype == torch.int16
    lib = kb.library("viterbi_traceback", _VIT_SIG)
    with torch.cuda.device(bp.device):
        rc = lib.np_viterbi_walk_launch(
            kb.ptr(bp), kb.ptr(xyc), kb.ptr(m), kb.ptr(n), kb.ptr(fstate),
            B, K1 - 1, W, int(full), kb.ptr(ops), kb.ptr(end),
            kb.stream_of(bp),
        )
    kb.check(lib, rc, "viterbi_traceback")
    (VIT_FULL_LAUNCHES if full else VIT_LAUNCHES).add()
    return ops, end


def viterbi_walk_plain(bp, xyc, m, n, fstate):
    """The Viterbi walker in plain PyTorch: vectorised over the batch,
    one loop step per diagonal, descending; the plane's rule by its
    dtype (int16: the full plane)."""
    B, K1, W = bp.shape
    dev = bp.device
    d1 = ((xyc[:, :, 0].to(torch.int32) & 0xFF) >> 6) & 1
    offs = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                      torch.cumsum(d1, dim=1, dtype=torch.int32)], dim=1)
    full = bp.dtype == torch.int16
    i = m.to(torch.int32).clone()
    j = n.to(torch.int32).clone()
    s = fstate.to(torch.int32).clone()
    rows = torch.arange(B, device=dev)
    ops = torch.empty((B, K1), dtype=torch.int8, device=dev)
    for k in range(K1 - 1, -1, -1):
        active = (i + j == k) & ~((i == 0) & (j == 0))
        b = j - offs[:, k]
        in_band = (b >= 0) & (b < W)
        p = bp[rows, k, b.clamp(0, W - 1).long()].to(torch.int32)
        p = torch.where(in_band, p, 0)
        if full:
            prev = (p >> (3 * s)) & 7
        else:
            bit = ((p // 5) >> (s - 1).clamp(min=0)) & 1
            prev = torch.where(s == 0, p % 5, s * bit)
        is_m = s == 0
        is_d = (s == 1) | (s == 3)
        op = torch.where(is_m, OP_M, torch.where(is_d, OP_D, OP_I))
        ops[:, k] = torch.where(active, op, OP_NONE).to(torch.int8)
        i = i - (active & ~is_d).to(torch.int32)
        j = j - (active & (is_m | is_d)).to(torch.int32)
        s = torch.where(active, prev, s)
    return ops, torch.stack([i, j], dim=1)


def rle_ops_batch(ops_b: np.ndarray) -> list[list[tuple[int, int]]]:
    """Vectorised batch run-length encode: (B, K1) op codes -> cigars.

    One set of full-matrix numpy passes instead of B per-row passes;
    row boundaries break runs via the row-id stream, and per-read work
    is O(#runs) only.
    """
    ops_b = np.ascontiguousarray(ops_b)
    B = ops_b.shape[0]
    mask = ops_b != OP_NONE
    counts = mask.sum(axis=1)
    flat = ops_b[mask]
    if flat.size == 0:
        return [[] for _ in range(B)]
    row_id = np.repeat(np.arange(B, dtype=np.int64), counts)
    brk = np.nonzero(
        (flat[1:] != flat[:-1]) | (row_id[1:] != row_id[:-1])
    )[0]
    starts = np.concatenate([[0], brk + 1])
    lens = np.diff(np.concatenate([starts, [flat.size]]))
    run_ops = flat[starts]
    run_rows = row_id[starts]
    # map op codes with one LUT and convert both run arrays to Python
    # lists in one pass each; never call int() per element
    lut = np.zeros(max(_OP_TO_CIG) + 1, np.int64)
    for k, v in _OP_TO_CIG.items():
        lut[k] = v
    cig_ops = lut[run_ops].tolist()
    lens_l = lens.tolist()
    bounds = np.searchsorted(run_rows, np.arange(B + 1)).tolist()
    out: list[list[tuple[int, int]]] = []
    for b in range(B):
        lo, hi = bounds[b], bounds[b + 1]
        out.append(list(zip(cig_ops[lo:hi], lens_l[lo:hi])))
    return out


def mea_traceback_fwd(
    dirs: np.ndarray, offsets: np.ndarray, m: int, n: int
) -> list[tuple[int, int]]:
    """Host traceback of one read's forward direction codes into a
    global SAM cigar consuming exactly m read / n ref bases."""
    dirs = np.asarray(dirs)
    offsets = np.asarray(offsets)
    i = j = 0
    ops: list[int] = []
    W = dirs.shape[1]
    while i < m or j < n:
        k = i + j
        b = j - offsets[k]
        d = dirs[k, b] if 0 <= b < W else DIR_NONE
        if d == DIR_DIAG and i < m and j < n:
            ops.append(CIG.M)
            i += 1
            j += 1
        elif d == DIR_DEL and j < n:
            ops.append(CIG.D)
            j += 1
        elif d == DIR_INS and i < m:
            ops.append(CIG.I)
            i += 1
        else:
            # off-band / degenerate fallback: consume what's left
            if j < n:
                ops.append(CIG.D)
                j += 1
            else:
                ops.append(CIG.I)
                i += 1
    cigar: list[tuple[int, int]] = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + 1)
        else:
            cigar.append((op, 1))
    return cigar
