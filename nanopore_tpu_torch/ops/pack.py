"""On-device band construction: host stream pack + the pack kernel.

Counterpart of ``nanopore_tpu/ops/pack_pallas.py``.  Along the
anti-diagonal sweep the band's x-window and y-window are sliding windows
over the raw sequences: the band is Lipschitz-1, so per diagonal exactly
one new symbol enters (an x symbol when the band shifts, a y symbol when
it does not):

    xwin_k[w] = x[o[k] + w - 1]        (shifts up when d1[k] = 1)
    ywin_k[w] = y[k - o[k] - w - 1]    (shifts down when d1[k] = 0)

so the host streams one byte per diagonal per read:

    bits 0-2  the entering symbol (x[o[k]+W-2] if d1[k] else y[k-o[k]-1])
    bit 6     d1[k]   = o[k] - o[k-1]   (the band delta)
    bit 7     d1[k-1]                    (the previous delta)

plus a (W,) x-window seed per read.  A band of live width w <= W lies
in the first w lanes of a W-lane layout (``padded_width``): its offsets
are those of width w, its windows those of all W lanes, and lanes w..W-1
carry the sentinel in bits 0-5 (bits 6-7 as in every lane), so they
emit nothing.  The plain version slides both
windows one diagonal at a time.  The pack kernel (``csrc/pack.cu``)
reads them as lookups instead: with o[k] the prefix sum of the delta
bits and c[k] = k - o[k], xwin_k[w] = X[o[k] + w] over X = the seed
followed by the entering x symbols, and ywin_k[w] = Y[c[k] - w] over the
entering y symbols, for any byte stream.  Both recompute cell validity
from (k, o[k], w, m, n) and write the packed band codes ``xyc``
(B, k_pad, W) int8, row r = diagonal r + 1, byte = x*8 + y with sentinel
5 outside the lattice, N = 4, bit 6 = d1[k], bit 7 = d1[k-1].
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nanopore_tpu_torch.kernels import build as kb
from nanopore_tpu_torch.ops.pairhmm import band_offsets_from_cigar

# diagonal counts round up to this multiple (the JAX package's CHUNK,
# so both packages lay out the same k_pad and compare row for row)
K_ALIGN = 128
SENT = (5 << 3) | 5  # all-sentinel packed code
# W = 32 * band cells per lane (up to 4; above W = 128 a band is held
# by a group of W / 128 warps of 4, above 1024 by a cluster of two
# blocks of 6 or 8 warps): the layouts of the MEA path (pack, realign in
# every mode, the MEA walker)
KERNEL_BAND_WIDTHS = (32, 64, 128, 256, 384, 512, 768, 1024, 1536, 2048)
# the layouts of the Viterbi path (the Viterbi, its walker, forward-only):
# the MEA path's up to 1024 (C11 takes one path at a time above it)
VITERBI_BAND_WIDTHS = KERNEL_BAND_WIDTHS[:8]
MIN_BAND_WIDTH = 2  # the narrowest live width the card serves
# the paths of ``check_band_width``, as ``MapperConfig.decode`` names them
# (any path but VITERBI is the MEA path's)
MEA, VITERBI = "mea", "viterbi"

LAUNCHES = kb.LaunchCounter("pack")


def padded_width(band_width: int) -> int:
    """The lanes a band of live width ``band_width`` is laid into, on
    either device: the narrowest kernel width that holds it (32, 64, 128,
    256, 384, 512, 768, 1024, 1536 or 2048); a wider band, which only the
    CPU serves, keeps its own width."""
    for W in KERNEL_BAND_WIDTHS:
        if band_width <= W:
            return W
    return band_width


def check_band_width(band_width: int, device=None, path: str = VITERBI
                     ) -> None:
    """Refuse a band width the kernels of ``path`` do not serve, where
    ``device`` is not the CPU (``None`` is the card), before an entry
    point does any work (ROADMAP C10, C11).  On the card the MEA path
    (``MEA``: pack, realign in every mode, the MEA walker) serves every
    live width from 2 to 2048, laid into its W = 32, 64, 128, 256, 384,
    512, 768, 1024, 1536 or 2048 kernels (the last two a read's band on
    a cluster of two blocks), and the Viterbi path (``VITERBI``, the
    default: pack, the Viterbi, its walker and the forward-only kernel)
    every width from 2 to 1024, in the same layouts up to 1024; the MEA
    path refuses a band above 2048 and the Viterbi path one above 1024
    (the rest of C11).  The plain versions on the CPU serve any width;
    the card gets no plain fallback."""
    if torch.device("cuda" if device is None else device).type == "cpu":
        return
    top = (VITERBI_BAND_WIDTHS if path == VITERBI else KERNEL_BAND_WIDTHS)[-1]
    if not MIN_BAND_WIDTH <= band_width <= top:
        raise ValueError(
            "band width %d is not served on the card by the %s path: the "
            "MEA path's kernels take widths %d to %d and the Viterbi "
            "path's %d to %d (ROADMAP C10; wider bands are C11); pass "
            "device='cpu' to run the plain path at any width"
            % (band_width, "Viterbi" if path == VITERBI else "MEA",
               MIN_BAND_WIDTH, KERNEL_BAND_WIDTHS[-1], MIN_BAND_WIDTH,
               VITERBI_BAND_WIDTHS[-1]))


_SIG = {
    "np_pack_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 2,
    "np_pack_attrs": [ctypes.c_int, ctypes.c_void_p],
}


def pack_stream_pairs(
    pairs: list[tuple[np.ndarray, np.ndarray, list[tuple[int, int]]]],
    band_width: int = 64,
    k_max: int | None = None,
    lanes: int | None = None,
) -> dict:
    """Host side of the on-device pack, batch-major.

    ``pairs`` are (ref window codes, read codes, guide cigar).  The band
    offsets are those of live width ``band_width``; the windows span
    ``lanes`` >= ``band_width`` lanes (default ``band_width``: no dead
    lanes), so the entering x symbol is the one of lane ``lanes`` - 1.
    Returns numpy ``stream`` (B, k_pad) uint8, ``initx`` (B, W) uint8,
    ``m``/``n``/``k_end`` (B,) int32, ``offsets`` (B, k_pad + 1) int32
    and the sizes ``k_pad``, ``K``, ``B``, ``W`` (= ``lanes``) and
    ``band_width``.
    """
    W = band_width if lanes is None else lanes
    if W < band_width:
        raise ValueError("lanes %d below the band width %d" % (W, band_width))
    B = len(pairs)
    ms = np.array([len(y) for _, y, _ in pairs], np.int32)
    ns = np.array([len(x) for x, _, _ in pairs], np.int32)
    K = int(k_max if k_max is not None else (ms + ns).max())
    k_pad = -(-K // K_ALIGN) * K_ALIGN

    stream = np.zeros((B, k_pad), np.uint8)
    initx = np.zeros((B, W), np.uint8)
    offsets = np.zeros((B, k_pad + 1), np.int32)
    karr = np.arange(1, k_pad + 1, dtype=np.int64)
    w = np.arange(W, dtype=np.int64)
    for b, (x, y, cig) in enumerate(pairs):
        x = np.asarray(x)
        y = np.asarray(y)
        m, n = len(y), len(x)
        o = band_offsets_from_cigar(cig, m, n, band_width, k_pad)
        offsets[b] = o
        d1 = (o[1:] - o[:-1]).astype(np.uint8)
        xq = x.astype(np.uint8) if n else np.zeros(1, np.uint8)
        yq = y.astype(np.uint8) if m else np.zeros(1, np.uint8)
        ix = np.clip(o[1:].astype(np.int64) + W - 2, 0, max(n - 1, 0))
        iy = np.clip(karr - o[1:] - 1, 0, max(m - 1, 0))
        byte = np.where(d1 == 1, xq[ix], yq[iy]) | (d1 << 6)
        byte[1:] |= d1[:-1] << 7
        stream[b] = byte
        initx[b] = xq[np.clip(w - 1, 0, max(n - 1, 0))]
    return {
        "stream": stream,
        "initx": initx,
        "m": ms,
        "n": ns,
        "k_end": (ms + ns).astype(np.int32),
        "offsets": offsets,
        "k_pad": k_pad,
        "K": K,
        "B": B,
        "W": W,
        "band_width": band_width,
    }


def _check_inputs(stream, initx, m, n):
    dev = stream.device
    for name, t, dt in (("stream", stream, torch.uint8),
                        ("initx", initx, torch.uint8),
                        ("m", m, torch.int32), ("n", n, torch.int32)):
        if t.device != dev:
            raise ValueError("%s is on %s, stream on %s" % (name, t.device, dev))
        if t.dtype != dt:
            raise TypeError("%s must be %s, got %s" % (name, dt, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    B, k_pad = stream.shape
    if initx.dim() != 2 or initx.shape[0] != B:
        raise ValueError("initx must be (B, W), got %s" % (tuple(initx.shape),))
    if tuple(m.shape) != (B,) or tuple(n.shape) != (B,):
        raise ValueError("m and n must be (B,)")


def live_width(band_width, W: int) -> int:
    """The live width of a W-lane layout (``None``: all W lanes), held
    to 1..W."""
    wl = W if band_width is None else int(band_width)
    if not 1 <= wl <= W:
        raise ValueError("live band width %d outside 1..%d" % (wl, W))
    return wl


def pack_xyc(stream, initx, m, n, band_width: int | None = None
             ) -> torch.Tensor:
    """Packed band codes (B, k_pad, W) int8 from the stream inputs, W the
    width of ``initx``; lanes at and above ``band_width`` (the live
    width; ``None``: W) hold the sentinel.

    Runs the CUDA kernel for tensors on the card and the plain version
    for tensors on the CPU.
    """
    _check_inputs(stream, initx, m, n)
    wl = live_width(band_width, initx.shape[1])
    if stream.device.type == "cpu":
        return pack_xyc_plain(stream, initx, m, n, wl)
    B, k_pad = stream.shape
    W = initx.shape[1]
    if W not in KERNEL_BAND_WIDTHS or k_pad % 32:
        raise ValueError(
            "pack kernel serves W in %s and k_pad a multiple of 32, got "
            "W=%d k_pad=%d" % (KERNEL_BAND_WIDTHS, W, k_pad)
        )
    out = torch.empty((B, k_pad, W), dtype=torch.int8, device=stream.device)
    if B == 0:
        return out
    lib = kb.library("pack", _SIG)
    with torch.cuda.device(stream.device):
        rc = lib.np_pack_launch(
            kb.ptr(stream), kb.ptr(initx), kb.ptr(m), kb.ptr(n),
            B, k_pad, W, wl, kb.ptr(out), kb.stream_of(stream),
        )
    kb.check(lib, rc, "pack")
    LAUNCHES.add()
    return out


def kernel_attributes(W: int) -> dict:
    """The compiled pack kernel's registers, local-memory (spill) bytes
    per thread, static shared memory and threads per block (one block a
    read) at band width ``W`` (needs the card: builds the kernel)."""
    lib = kb.library("pack", _SIG)
    vals = (ctypes.c_int * 4)()
    kb.check(lib, lib.np_pack_attrs(W, vals), "pack attrs")
    return dict(zip(("registers", "local_bytes", "static_smem", "threads"),
                    vals))


def pack_xyc_plain(stream, initx, m, n, band_width: int | None = None
                   ) -> torch.Tensor:
    """The pack in plain PyTorch: vectorised over batch and band, one
    loop step per diagonal."""
    B, k_pad = stream.shape
    W = initx.shape[1]
    wl = live_width(band_width, W)
    dev = stream.device
    s = stream.to(torch.int32)
    xw = initx.to(torch.int32)
    yw = torch.full((B, W), 5, dtype=torch.int32, device=dev)
    o = torch.zeros(B, dtype=torch.int32, device=dev)
    w = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    mm = m[:, None]
    nn = n[:, None]
    five = torch.full((), 5, dtype=torch.int32, device=dev)
    out = torch.empty((B, k_pad, W), dtype=torch.uint8, device=dev)
    for r in range(k_pad):
        byte = s[:, r]
        d1 = (byte >> 6) & 1
        ent = (byte & 7)[:, None]
        shift = d1[:, None] == 1
        # x window slides up when the band shifts, y window down when not
        xw = torch.where(shift, torch.cat([xw[:, 1:], ent], 1), xw)
        yw = torch.where(shift, yw, torch.cat([ent, yw[:, :-1]], 1))
        o = o + d1
        j = o[:, None] + w
        i = (r + 1) - j
        ok = (j <= nn) & (i >= 0) & (i <= mm) & (w < wl)
        xv = torch.where(ok & (j >= 1), xw, five)
        yv = torch.where(ok & (i >= 1), yw, five)
        out[:, r] = (xv * 8 + yv + (byte & 0xC0)[:, None]).to(torch.uint8)
    return out.view(torch.int8)
