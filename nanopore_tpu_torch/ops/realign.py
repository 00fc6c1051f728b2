"""Fused banded realign: forward, backward, then one of five outputs.

Counterpart of ``nanopore_tpu/ops/pairhmm_pallas_realign.py`` in its
modes:

* decode (``emit_em=False``): per read the forward log-likelihood, the
  MEA score and the (k_pad + 1, W) 2-bit direction codes (0 diag, 1 del,
  2 ins, 3 none) that ``ops.traceback`` walks into a cigar;
* decode + gamma (``emit_gamma=True``): the same, plus the gamma_match
  band (k_pad + 1, W) f32 of the same launch (the rescore of realigned
  cigars);
* gamma: the log-likelihood and the gamma_match band only (no MEA DP, no
  direction codes; AlignmentUncertainty);
* exp (``emit_exp=True``): the log-likelihood, the (k_pad + 1, 4) retire
  stream and the (4, W) flush of the thresholded gamma_match binned by
  read base (the SNP caller's expected base counts; no MEA DP);
* EM (``emit_em=True``): per read the log-likelihood and the Baum-Welch
  expected counts, ``trans`` (5, 5) and ``emis`` (5, 16).  The port's EM
  mode runs no MEA DP and writes no direction codes (the E-step has no
  use for them).

Each mode has its own launch counter (``realign``,
``realign_decode_gamma``, ``realign_gamma``, ``realign_exp``,
``realign_em``).

Numerics, shared by the kernel (``csrc/realign.cu``) and the plain
version below, operation for operation:

* five-state scaled f32 recursion over the anti-diagonals; the forward
  rescales every 2nd diagonal (even k) by the band maximum and keeps the
  running log-scale in a Kahan-compensated sum (a plain f32 sum drifts
  by nats at K ~ 10^4);
* per-read band shifts come from the code bits: d1 = bit 6, d1p =
  bit 7, d2 = d1 + d1p - 1; shifted-in cells are 0 for probabilities
  and NEG for MEA scores;
* validity rides the sentinel code 5 (zero emission), N = 4 takes the
  mean rows of the tables: no per-cell mask.  A band of live width
  w < W (``band_width``) lies in the first w lanes, its dead lanes all
  sentinel (``ops.pack``): they hold no forward mass, the backward holds
  0 in them and the MEA NEG (what each shifts in from outside the band),
  and the exp mode retires column w - 1.  So the live lanes compute what
  a band of width w computes, bit for bit, and the dead ones add +0 to
  every sum;
* the backward rescales every odd diagonal and diagonal 0; the
  posterior factor is the linear g-factor g_k = g_{k+1} sfinv_{k+1}
  safe_k, clamped at 3e37 and seeded 1/fin(k_end), where fin(k_end) is
  the forward band-start mass at the read's end diagonal;
* the reverse MEA breaks ties diag before del before ins and emits
  DIR_NONE where the score is unreachable or k == k_end;
* EM mode sums, per backward diagonal k, the 25 transition products
  f_k[s] * (g_{k+1} sfinv_{k+1}) * dest[t] (``dest`` the shifted
  emission-weighted backward values, before the end-cell overwrite) and
  bins gamma by the diagonal's base codes: the match state by (x, y)
  into 16 counts, the delete states by x and the insert states by y
  into 2 x 4 each; only codes 0-3 bin (N = 4 and the sentinel nowhere).
  A lane adds its C adjacent cells into one accumulator per count, the
  L lanes are summed by an xor butterfly (offsets L / 2, .., 2, 1) at
  the end, and only then do the transition sums take their ``tf``
  factor (:func:`em_lanes`: up to W = 128 one warp, L = 32 lanes of
  W / 32 cells; above, a group of G = W / 128 warps, L = 32 G lanes of
  4, whose warps first fold onto warp 0, the upper ceil(G / 2) onto the
  lower, lane for lane, until one is left: at G = 2, 4 and 8 the
  butterfly's steps across warps, at G = 3 warp 2 onto warp 0, then
  warp 1, at G = 6 warps 3-5 onto 0-2, then warp 2 onto warp 0, then
  warp 1; at W = 1536 and 2048, G = 12 and 16 warps on a cluster of two
  blocks, the first step is block 1's warps onto block 0's, then the
  fold of 6 or 8).  The plain version adds in the same order.
* the gamma band is gamma[0] = (f_k[0] * b_k[0]) * g_k of every band
  cell, diagonal 0 included: the value the MEA reads;
* the exp mode keeps 4 accumulators per band cell in diagonal k's band
  coordinates.  On the k+1 -> k step it emits column w - 1 times d1[k+1]
  as retire row k (reference position o[k+1] + w - 2, valid where
  d1[k+1] = 1), moves the band up as acc + d1 * (shifted - acc) with 0
  shifted in and zeroes the columns at and above w, then adds gamma[0] *
  (gamma[0] > threshold) times the one-hot of the cell's read base
  (codes 0-3; N, the sentinel and diagonal 0 bin nowhere).  The
  accumulator left after diagonal 0 is the flush, column w = position
  w - 1.  The multiplies by 0/1 factors are the TPU kernel's, so a
  non-finite gamma spreads as it does there.

The forward states of every diagonal are kept (the TPU kernel's
``store_fwd`` mode, 5 * W * 4 bytes per diagonal per read) and streamed
back in descending order by the backward.  The kernel runs each read
over its own diagonals only (m + n rounded up to even), with its states
at its own offset in a ragged workspace (:func:`workspace_plan`), and
writes the rows past them as the plain version's padding diagonals
leave them (0; DIR_NONE in the direction codes); the plain version runs
every diagonal of the batch.  Up to W = 512 the decode modes run the
forward and the backward side by side on two warps (or groups) of a
block: their slot also holds the backward's scale of every diagonal
and, every :func:`segment` diagonals, a checkpoint of the backward
states it carries, from which two more warps recompute the backward for
the MEA pass.  Above W = 512 (768 and 1024) every mode runs the forward,
then the backward, on one group of W / 128 warps (:func:`two_phase`),
in the EM mode's slot; at 1536 and 2048 (``CLUSTER_WIDTHS``) that group
is 12 or 16 warps on a thread-block cluster of two blocks, one an SM
(csrc/group.cuh's cluster tier), launched as nreads clusters, and the
launch first asks the card how many such clusters fit at once: none
raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nanopore_tpu_torch.kernels import build as kb
from nanopore_tpu_torch.ops.pack import (
    KERNEL_BAND_WIDTHS,
    SENT,
    live_width,
    padded_width,
)
from nanopore_tpu_torch.ops.pairhmm import KernelParams, kernel_tables

NUM_STATES = 5
NEG = -1e30
DIR_NONE = 3
# forward-state workspace of one launch; a batch whose reads need more
# launches over runs of reads that fit
WORKSPACE_BYTES = 8 << 30
# diagonals per backward segment of the decode modes (csrc/realign.cu S)
# up to W = 256; half that above (:func:`segment`)
SEGMENT = 8
# diagonals whose code lookups (emission factors, band deltas, shift
# indices) the plain versions take in one batch of operations (a plain
# version is bound by its count of operations); but one at a time on the
# CPU with more than one intra-op thread, where a batch crosses torch's
# grain for threads whose spinning workers then take the cores of every
# other process (a parallel test run's workers)
LOOKUP_DIAGS = 64

# the band widths at which a read's band is held by a cluster of two
# blocks (csrc/realign.cu, CB = 2)
CLUSTER_WIDTHS = (1536, 2048)

LAUNCHES = kb.LaunchCounter("realign")
EM_LAUNCHES = kb.LaunchCounter("realign_em")
GAMMA_LAUNCHES = kb.LaunchCounter("realign_gamma")
DECODE_GAMMA_LAUNCHES = kb.LaunchCounter("realign_decode_gamma")
EXP_LAUNCHES = kb.LaunchCounter("realign_exp")
# kernel modes (the ``mode`` argument of np_realign_launch)
DECODE, EM, GAMMA, DECODE_GAMMA, EXP = range(5)
_SIG = {
    "np_realign_launch": [ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7,
    "np_realign_attrs": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
MODE_NAMES = {DECODE: "decode", EM: "em", GAMMA: "gamma",
              DECODE_GAMMA: "decode_gamma", EXP: "exp"}
MEA_MODES = (DECODE, DECODE_GAMMA)


def two_phase(W: int) -> bool:
    """Whether every mode runs the kernel's forward-then-backward layout
    on one group at band width ``W``, with the EM mode's workspace slot:
    above 512 (csrc/realign.cu, ``two_phase``), where the decode modes'
    three roles and the gamma mode's would not fit an SM (at 1536 and
    2048 the group spans the two blocks of a cluster)."""
    return W > 512


def segment(W: int) -> int:
    """Diagonals per backward segment of the decode modes at band width
    ``W``: ``SEGMENT``, but half of it above W = 256, where the
    kernel's staging of a segment at 8 diagonals would not fit a block
    (csrc/realign.cu, ``mea_segment``)."""
    return SEGMENT if W <= 256 else SEGMENT // 2


def read_workspace_bytes(kend, W: int, mode: int = EM) -> np.ndarray:
    """Workspace bytes of reads whose diagonals end at ``kend`` (m + n)
    under kernel ``mode``: the kernel runs kq = kend rounded up to even
    diagonals.  ``EM`` and ``EXP`` keep kq x 5 x W f32 forward states,
    then kq + 1 rescale inverses padded to 16 bytes (the next read's
    states start aligned).  The decode modes (``MEA_MODES``) add the
    backward's kq + 1 scales, padded the same way, and kq // segment(W)
    + 1 checkpoints of 6 x W f32 (the five states the backward carries
    and the match state of the diagonal above them), one per segment of
    diagonals 0..kq.  ``GAMMA``, whose forward writes its match state
    into the gamma band, keeps the backward's match state alone,
    (kq + 1) x W f32 for diagonals 0..kq, then the forward's rescale
    inverses and the backward's scales, each padded as above.  Above
    W = 512 (:func:`two_phase`) every mode keeps the ``EM`` slot."""
    kq = np.asarray(kend, dtype=np.int64)
    kq = kq + (kq & 1)
    scales = ((kq + 1 + 3) // 4) * 16
    if two_phase(W):
        mode = EM
    if mode == GAMMA:
        return (kq + 1) * W * 4 + 2 * scales
    nbytes = kq * NUM_STATES * W * 4 + scales
    if mode in MEA_MODES:
        nbytes = nbytes + scales + (kq // segment(W) + 1) * (
            NUM_STATES + 1) * W * 4
    return nbytes


def workspace_plan(m, n, W: int, cap: int = WORKSPACE_BYTES, mode: int = EM):
    """The launches of a batch and its ragged workspace.

    Returns ``offsets`` (B + 1,) int64, the exclusive prefix sum of
    :func:`read_workspace_bytes` over the batch (read r's workspace
    starts ``offsets[r] - offsets[r0]`` bytes into its launch's, r0 the
    launch's first read), and ``launches``, a list of (r0, r1) runs of
    reads in batch order: each run's workspace fits ``cap``, except a
    read that alone exceeds it, which launches alone.  ``mode`` picks
    the slot, as for :func:`read_workspace_bytes`.
    """
    nbytes = read_workspace_bytes(
        np.asarray(m, dtype=np.int64) + np.asarray(n, dtype=np.int64), W,
        mode)
    offsets = np.zeros(len(nbytes) + 1, dtype=np.int64)
    np.cumsum(nbytes, out=offsets[1:])
    launches, r0 = [], 0
    for r in range(1, len(nbytes)):
        if offsets[r + 1] - offsets[r0] > cap:
            launches.append((r0, r))
            r0 = r
    if len(nbytes):
        launches.append((r0, len(nbytes)))
    return offsets, launches


def launch_offsets(offsets, launches) -> np.ndarray:
    """The kernel's ``woff`` for the launches of :func:`workspace_plan`:
    launch l's r1 - r0 + 1 values at index r0 + l, each read's offset in
    floats from the launch's workspace start and, last, the end of its
    last read's slot (the kernel holds each read to its slot's end)."""
    return np.concatenate([(offsets[r0:r1 + 1] - offsets[r0]) // 4
                           for r0, r1 in launches])


def max_workspace_k(W: int, mode: int = EM) -> int:
    """The largest diagonal count at which one read's workspace under
    kernel ``mode`` still fits ``WORKSPACE_BYTES``: the realign stage
    (``DECODE``) and the SNP caller (``EXP``) split longer windows.  A
    mode outside ``MEA_MODES`` gets the 5-state slot's budget, which the
    smaller ``GAMMA`` slot also fits, and so does every mode above
    W = 512 (:func:`two_phase`)."""
    if mode not in MEA_MODES or two_phase(W):
        return (WORKSPACE_BYTES - 4) // (NUM_STATES * W * 4 + 4)
    per_k = NUM_STATES * W * 4 + 8 + (NUM_STATES + 1) * W * 4 / segment(W)
    k = int(WORKSPACE_BYTES // per_k)
    while read_workspace_bytes(k, W, mode) > WORKSPACE_BYTES:
        k -= 1
    return k


def _attributes(mode: int, W: int) -> list:
    """``np_realign_attrs`` of ``mode``'s build at band width ``W``, on
    the current device: registers, local bytes, static and dynamic
    shared memory, threads and reads a block, blocks a cluster and the
    clusters resident at once (-1 without a cluster)."""
    lib = kb.library("realign", _SIG)
    vals = (ctypes.c_int * 8)()
    kb.check(lib, lib.np_realign_attrs(mode, W, vals), "realign attrs")
    return list(vals)


def kernel_attributes(W: int) -> dict:
    """Per mode, the compiled kernel's registers, local-memory (spill)
    bytes per thread, static and dynamic shared memory per block,
    threads and reads per block, blocks per cluster (2 at
    ``CLUSTER_WIDTHS``, else 1) and the clusters the card can hold at
    once (``cudaOccupancyMaxActiveClusters``; None without a cluster) at
    band width ``W`` (needs the card: builds the kernel)."""
    out = {}
    for mode, name in MODE_NAMES.items():
        vals = _attributes(mode, W)
        out[name] = dict(zip(("registers", "local_bytes", "static_smem",
                              "dynamic_smem", "threads", "reads",
                              "cluster_blocks"), vals))
        out[name]["clusters"] = None if vals[7] < 0 else vals[7]
    return out


_clusters_fit = set()  # (mode, W, device index) the card was asked about


def check_clusters(mode: int, W: int, device) -> None:
    """Raise unless ``device`` can hold at least one cluster of ``mode``'s
    build at band width ``W`` (one of ``CLUSTER_WIDTHS``: two blocks of
    its shared memory), asked of the card once per build and device;
    there is no fallback."""
    key = (mode, W, torch.device(device).index)
    if key in _clusters_fit:
        return
    with torch.cuda.device(device):
        vals = _attributes(mode, W)
    if vals[7] <= 0:
        raise RuntimeError(
            "the realign kernel's %s mode at W = %d holds a read on a "
            "cluster of %d blocks of %d bytes of shared memory, and this "
            "card can hold no such cluster (cudaOccupancyMaxActiveClusters "
            "= %d)" % (MODE_NAMES[mode], W, vals[6], vals[2] + vals[3],
                       vals[7]))
    _clusters_fit.add(key)


def _check_inputs(xyc, m, n):
    dev = xyc.device
    if xyc.dtype != torch.int8 or xyc.dim() != 3 or not xyc.is_contiguous():
        raise ValueError("xyc must be a contiguous (B, k_pad, W) int8 tensor")
    for name, t in (("m", m), ("n", n)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("%s must be contiguous int32 on %s" % (name, dev))
        if tuple(t.shape) != (xyc.shape[0],):
            raise ValueError("%s must be (B,)" % name)


def check_kend(kend, B: int) -> None:
    """``kend``, the caller's host copy of m + n, must be None or a 1-D
    integer array of B values, none negative: the launch plan sizes
    each read's workspace slot from it.  A value above k_pad is allowed
    (a batch whose k_max was capped; the kernel clamps its diagonals to
    k_pad).  A value below the device's m + n is refused by the kernel,
    which traps on the device when a read needs more workspace
    than its slot (it surfaces at the next synchronise)."""
    if kend is None:
        return
    arr = np.asarray(kend)
    if arr.ndim != 1 or arr.shape[0] != B:
        raise ValueError("kend must be 1-D of length B=%d, got shape %s"
                         % (B, arr.shape))
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError("kend must be integers, got %s" % arr.dtype)
    if B and arr.min() < 0:
        raise ValueError("kend must not be negative")


def _tables(params: KernelParams, gap_gamma: float = 0.0,
            match_gamma: float = 0.0, exp_threshold: float = 0.0):
    """The kernel's 94 floats: the model's 91, then gap gamma, match
    gamma and the exp threshold."""
    return torch.cat([
        kernel_tables(params),
        torch.tensor([gap_gamma, match_gamma, exp_threshold],
                     dtype=torch.float32),
    ]).contiguous()


def _launch(mode: int, counter, xyc, m, n, tables, outs, kend=None,
            wl: int | None = None) -> None:
    """Launch ``mode`` over the runs of reads of :func:`workspace_plan`,
    in batch order: each read's forward states sit in a ragged workspace
    at its own offset, sized by its own diagonals, so a batch whose reads
    fit ``WORKSPACE_BYTES`` together is one launch.  ``outs`` are the
    four per-read output tensors (loglik, out1, out2, out3; None where
    the mode writes nothing), the whole batch's; a launch writes its
    reads' slice, and a gamma band of (B, k_pad + 1, W) f32 lies beside
    the workspace, not inside its cap.  ``kend`` is the host's copy of
    m + n (numpy); without it m and n are read back from the device, a
    copy that waits for the stream's earlier work (so a caller that
    queues batches back to back passes it; :func:`check_kend` holds
    its shape, and the kernel each read's m + n to its slot).  ``wl`` is
    the live band width (``None``: W).  One count per kernel launch."""
    B, k_pad, W = xyc.shape
    if W not in KERNEL_BAND_WIDTHS or k_pad % 2:
        raise ValueError(
            "realign kernel serves W in %s and even k_pad, got W=%d "
            "k_pad=%d" % (KERNEL_BAND_WIDTHS, W, k_pad)
        )
    wl = live_width(wl, W)
    if B == 0:
        return
    if W in CLUSTER_WIDTHS:
        check_clusters(mode, W, xyc.device)
    if kend is None:
        kend = (m.to(torch.int64) + n.to(torch.int64)).cpu().numpy()
    offsets, launches = workspace_plan(kend, 0, W, WORKSPACE_BYTES,  # m + n, 0
                                       mode)
    slots = launch_offsets(offsets, launches)
    dev = xyc.device
    ws = torch.empty(int(slots.max()), dtype=torch.float32, device=dev)
    woff = torch.from_numpy(slots).pin_memory().to(dev, non_blocking=True)
    lib = kb.library("realign", _SIG)
    with torch.cuda.device(dev):
        for l, (r0, r1) in enumerate(launches):
            rc = lib.np_realign_launch(
                mode, ctypes.c_void_p(tables.data_ptr()),
                kb.ptr(xyc[r0:r1]), kb.ptr(m[r0:r1]), kb.ptr(n[r0:r1]),
                r1 - r0, k_pad, W, wl, kb.ptr(ws), kb.ptr(woff[r0 + l:]),
                *(ctypes.c_void_p(None) if o is None else kb.ptr(o[r0:r1])
                  for o in outs),
                kb.stream_of(xyc),
            )
            kb.check(lib, rc, counter.name)
            counter.add()
    # ``tables`` is copied into the kernel arguments at launch; the
    # workspace and offsets return to the caching allocator, whose reuse
    # of them is ordered on this stream


def realign_decode(xyc, m, n, params: KernelParams, gap_gamma: float = 0.5,
                   match_gamma: float = 0.0, emit_gamma: bool = False,
                   kend=None, band_width: int | None = None) -> dict:
    """Decode-mode fused realign over packed band codes.

    xyc (B, k_pad, W) int8, m / n (B,) int32 read / window lengths.
    Returns loglik (B,) f32, score (B,) f32 and dirs (B, k_pad + 1, W)
    int8 (row k = diagonal k); ``emit_gamma`` adds the gamma_match band
    ``gamma`` (B, k_pad + 1, W) f32 of the same launch.  CUDA tensors
    launch the kernel, CPU tensors run the plain version.  ``kend``, the
    host's m + n (numpy), spares the kernel's launch plan a read-back of
    m and n from the device; it must be 1-D of length B with no negative
    value (:func:`check_kend`, on either device).  ``band_width`` is the
    live width of the codes' band (``None``: W); the lanes at and above
    it are dead (the module's numerics).
    """
    _check_inputs(xyc, m, n)
    check_kend(kend, xyc.shape[0])
    wl = live_width(band_width, xyc.shape[2])
    if xyc.device.type == "cpu":
        return realign_decode_plain(xyc, m, n, params, gap_gamma, match_gamma,
                                    emit_gamma, wl)
    B, k_pad, W = xyc.shape
    out = {
        "loglik": xyc.new_empty(B, dtype=torch.float32),
        "score": xyc.new_empty(B, dtype=torch.float32),
        "dirs": xyc.new_empty((B, k_pad + 1, W), dtype=torch.int8),
    }
    if emit_gamma:
        out["gamma"] = xyc.new_empty((B, k_pad + 1, W), dtype=torch.float32)
    _launch(DECODE_GAMMA if emit_gamma else DECODE,
            DECODE_GAMMA_LAUNCHES if emit_gamma else LAUNCHES, xyc, m, n,
            _tables(params, gap_gamma, match_gamma),
            (out["loglik"], out["score"], out["dirs"], out.get("gamma")),
            kend, wl)
    return out


def realign_em(xyc, m, n, params: KernelParams, kend=None,
               band_width: int | None = None) -> dict:
    """EM-mode fused realign: the Baum-Welch E-step of one batch.

    Inputs (``kend``, ``band_width``) as :func:`realign_decode`.  Returns
    loglik (B,) f32, trans (B, 5, 5) f32 expected transition counts [from, to]
    and emis
    (B, 5, 16) f32 expected emission counts [state, x * 4 + y] (the gap
    states' counts spread evenly over the base they do not read).  CUDA
    tensors launch the kernel, CPU tensors run the plain version.
    """
    _check_inputs(xyc, m, n)
    check_kend(kend, xyc.shape[0])
    wl = live_width(band_width, xyc.shape[2])
    if xyc.device.type == "cpu":
        return realign_em_plain(xyc, m, n, params, wl)
    B = xyc.shape[0]
    out = {
        "loglik": xyc.new_empty(B, dtype=torch.float32),
        "trans": xyc.new_empty((B, 5, 5), dtype=torch.float32),
        "emis": xyc.new_empty((B, 5, 16), dtype=torch.float32),
    }
    _launch(EM, EM_LAUNCHES, xyc, m, n, _tables(params),
            (out["loglik"], out["trans"], out["emis"], None), kend, wl)
    return out


def realign_gamma(xyc, m, n, params: KernelParams, kend=None,
                  band_width: int | None = None) -> dict:
    """Gamma-mode fused realign: the posterior match probabilities.

    Inputs (``kend``, ``band_width``) as :func:`realign_decode`.  Returns loglik
    (B,) f32 and the gamma_match band ``gamma`` (B, k_pad + 1, W) f32,
    row k = diagonal k,
    column w = band cell w (reference position o[k] + w); no MEA and no
    direction codes.  CUDA tensors launch the kernel, CPU tensors run the
    plain version.
    """
    _check_inputs(xyc, m, n)
    check_kend(kend, xyc.shape[0])
    wl = live_width(band_width, xyc.shape[2])
    if xyc.device.type == "cpu":
        return realign_gamma_plain(xyc, m, n, params, wl)
    B, k_pad, W = xyc.shape
    out = {
        "loglik": xyc.new_empty(B, dtype=torch.float32),
        "gamma": xyc.new_empty((B, k_pad + 1, W), dtype=torch.float32),
    }
    _launch(GAMMA, GAMMA_LAUNCHES, xyc, m, n, _tables(params),
            (out["loglik"], None, None, out["gamma"]), kend, wl)
    return out


def realign_exp(xyc, m, n, params: KernelParams,
                exp_threshold: float = 1e-3, kend=None,
                band_width: int | None = None) -> dict:
    """Exp-mode fused realign: the SNP caller's expectation streams.

    Inputs (``kend``, ``band_width``) as :func:`realign_decode`.  Returns
    loglik (B,) f32, ``ret`` (B, k_pad + 1, 4) f32 (row k: the expected
    base counts of reference position o[k+1] + w - 2, valid where
    d1[k+1] = 1, w the live width) and ``flush`` (B, 4, W) f32 (column
    w: position w - 1; 0 at and above the live width), summing the
    gamma_match values above ``exp_threshold`` by read base.  CUDA
    tensors launch the kernel, CPU tensors run the plain version.
    """
    _check_inputs(xyc, m, n)
    check_kend(kend, xyc.shape[0])
    wl = live_width(band_width, xyc.shape[2])
    if xyc.device.type == "cpu":
        return realign_exp_plain(xyc, m, n, params, exp_threshold, wl)
    B, k_pad, W = xyc.shape
    out = {
        "loglik": xyc.new_empty(B, dtype=torch.float32),
        "ret": xyc.new_empty((B, k_pad + 1, 4), dtype=torch.float32),
        "flush": xyc.new_empty((B, 4, W), dtype=torch.float32),
    }
    _launch(EXP, EXP_LAUNCHES, xyc, m, n, _tables(params, 0.0, 0.0,
                                                  exp_threshold),
            (out["loglik"], out["ret"], out["flush"], None), kend, wl)
    return out


def _shift(arr, s, fill, base):
    """out[b, p, w] = arr[b, p, w + s[b, p]] (``fill`` outside the band);
    s in [-1, 1] per read and plane, ``base`` = arange(W) + 1."""
    B, P, W = arr.shape
    pad = torch.full((B, P, 1), fill, dtype=arr.dtype, device=arr.device)
    padded = torch.cat([pad, arr, pad], dim=2)
    idx = (base[None, None, :] + s[:, :, None]).expand(B, P, W)
    return torch.gather(padded, 2, idx)


def _shift_at(arr, idx, pad):
    """:func:`_shift` with its gather index ``idx`` (B, P, W) and its
    fill column ``pad`` (B, P, 1) made beforehand."""
    return torch.gather(torch.cat([pad, arr, pad], dim=2), 2, idx)


def _by_chunk(make, first: int, device):
    """``lookup(k)``: the k-th entries (dim 1) of the tensors ``make(k0,
    k1)`` gives for diagonals k0 .. k1 - 1, made for LOOKUP_DIAGS
    diagonals at a time from ``first`` on (one at a time on the CPU with
    more than one intra-op thread) and read as views: the values one
    diagonal at a time gives, in a fraction of the operations."""
    one = torch.device(device).type == "cpu" and torch.get_num_threads() > 1
    n = 1 if one else LOOKUP_DIAGS
    held = [None]

    def lookup(k):
        q = (k - first) // n
        if held[0] is None or held[0][0] != q:
            k0 = first + q * n
            held[0] = (q, k0, make(k0, k0 + n))
        return tuple(t[:, k - held[0][1]] for t in held[0][2])

    return lookup


def _forward_lookups(codes, emf, egf, base):
    """The per-diagonal lookups of a forward over ``codes`` (B, k_pad, W)
    int32 (:func:`_by_chunk`): ``lookup(k)`` gives diagonal k's (k >= 1)
    emission factors [e_m, gx1, gy2, gx3, gy4] (B, 5, W) and the gather
    index (B, 5, W) of :func:`_shift` by its shifts (d1 + d1p - 1,
    d1 - 1, d1, d1 - 1, d1), bits 6-7 of its top code."""
    def make(k0, k1):
        c = codes[:, k0 - 1:k1 - 1]
        x = (c >> 3) & 7
        y = c & 7
        E = torch.stack([
            emf[x * 6 + y], egf[6 + x], egf[12 + y], egf[18 + x],
            egf[24 + y],
        ], dim=2)
        top = c[:, :, 0]
        d1, d1p = (top >> 6) & 1, (top >> 7) & 1
        S = torch.stack([d1 + d1p - 1, d1 - 1, d1, d1 - 1, d1], dim=2)
        return E, base + S[..., None]

    return _by_chunk(make, 1, codes.device)


def _seq_sum(prod):
    """Sum over dim 2 of (B, D, 5, W) in source order 0..4, each add
    rounded on its own (the kernel's order)."""
    acc = prod[:, :, 0]
    for s in range(1, NUM_STATES):
        acc = acc + prod[:, :, s]
    return acc


def em_lanes(W: int) -> int:
    """The lanes L of the EM mode's sums at band width ``W``, each
    owning W / L adjacent band cells: one warp's 32 up to W = 128 (a lane
    a cell below 32, the CPU's), then W / 4, the kernel's groups of
    W / 128 warps of 4 cells a lane (64 at W = 256, 96 at 384, 128 at
    512, 192 at 768, 256 at 1024, 384 and 512 on the clusters of
    W = 1536 and 2048; the CPU's wider bands, laid into the next power of
    two, follow the same rule)."""
    return min(W, 32) if W <= 128 else W // 4


def em_width(W: int) -> int:
    """The lanes the EM mode's plain version lays a band of ``W`` lanes
    into: from 129 to 2048 the kernel's layout (``ops.pack.padded_width``:
    384 for 257 to 384, 768 for 513 to 768, 1536 for 1025 to 1536), so
    the lane sums add in the kernel's order; elsewhere (a lane a cell up
    to 32, and the CPU's bands above 2048) the next power of two."""
    if 128 < W <= KERNEL_BAND_WIDTHS[-1]:
        return padded_width(W)
    return 1 << (W - 1).bit_length()


def _lane_add(acc, v):
    """acc (B, R, L) + v (B, R, L * C): lane l adds its C adjacent band
    cells one after the other (the kernel's order)."""
    B, R, L = acc.shape
    v = v.reshape(B, R, L, -1)
    for c in range(v.shape[3]):
        acc = acc + v[..., c]
    return acc


def _lane_total(acc):
    """Sum of (B, R, L) over the lanes in the kernel's order: above one
    warp (L = 32 G) the warps fold onto warp 0, warps h .. G' - 1 onto
    warps 0 .. G' - h - 1 lane for lane with h = ceil(G' / 2), G' the
    warps left (G' = 2 and 4: the xor butterfly's steps across warps);
    then one warp's xor butterfly over its lanes."""
    B, R, L = acc.shape
    if L > 32:
        warps = list(acc.reshape(B, R, L // 32, 32).unbind(2))
        while len(warps) > 1:
            h = (len(warps) + 1) // 2
            warps = [w + warps[h + i] if h + i < len(warps) else w
                     for i, w in enumerate(warps[:h])]
        acc, L = warps[0], 32
    lanes = torch.arange(L, device=acc.device)
    off = L // 2
    while off:
        acc = acc + acc[..., lanes ^ off]
        off //= 2
    return acc[..., 0]


def realign_decode_plain(xyc, m, n, params: KernelParams,
                         gap_gamma: float = 0.5,
                         match_gamma: float = 0.0,
                         emit_gamma: bool = False,
                         band_width: int | None = None) -> dict:
    """The decode-mode realign in plain PyTorch: vectorised over batch
    and band, one loop step per diagonal; the same arithmetic, in the
    same order, as the kernel (``emit_gamma``: its decode + gamma mode)."""
    return _realign_plain(xyc, m, n, params, gap_gamma, match_gamma,
                          DECODE_GAMMA if emit_gamma else DECODE,
                          band_width=band_width)


def pad_lanes(xyc, W: int):
    """The codes (B, k_pad, w) laid into W >= w lanes: each dead lane the
    all-sentinel code with its row's bits 6-7."""
    w = xyc.shape[2]
    if W == w:
        return xyc
    top = (xyc[:, :, :1].to(torch.int32) & 0xC0) | SENT
    dead = top.to(torch.uint8).view(torch.int8).expand(-1, -1, W - w)
    return torch.cat([xyc, dead], dim=2).contiguous()


def realign_em_plain(xyc, m, n, params: KernelParams,
                     band_width: int | None = None) -> dict:
    """The EM-mode realign in plain PyTorch (the same recursion as the
    decode mode, summing expected counts in place of the MEA DP).  The
    lane sums want the kernel's layout: codes of another width are laid
    into :func:`em_width` lanes, their new lanes dead (all sentinel),
    which add +0.0 to every count (a band of 129 to 256 in 256 lanes,
    257 to 384 in 384, 385 to 512 in 512, 513 to 768 in 768, 769 to
    1024 in 1024, 1025 to 1536 in 1536 and 1537 to 2048 in 2048, as the
    card lays them; above 2048, which only the CPU serves, 4,096 or more
    lanes, summed over ``em_lanes`` of them)."""
    W = xyc.shape[2]
    wl = live_width(band_width, W)
    xyc = pad_lanes(xyc, em_width(W))
    return _realign_plain(xyc, m, n, params, 0.0, 0.0, EM, band_width=wl)


def realign_gamma_plain(xyc, m, n, params: KernelParams,
                        band_width: int | None = None) -> dict:
    """The gamma-mode realign in plain PyTorch (the same recursion,
    storing gamma_match in place of the MEA DP)."""
    return _realign_plain(xyc, m, n, params, 0.0, 0.0, GAMMA,
                          band_width=band_width)


def realign_exp_plain(xyc, m, n, params: KernelParams,
                      exp_threshold: float = 1e-3,
                      band_width: int | None = None) -> dict:
    """The exp-mode realign in plain PyTorch (the same recursion, with
    the kernel's retire accumulator in place of the MEA DP)."""
    return _realign_plain(xyc, m, n, params, 0.0, 0.0, EXP, exp_threshold,
                          band_width)


def _realign_plain(xyc, m, n, params: KernelParams, gap_gamma: float,
                   match_gamma: float, mode: int,
                   exp_threshold: float = 0.0,
                   band_width: int | None = None) -> dict:
    """Forward and backward over the packed codes; ``mode`` (one of the
    kernel's) selects what the backward produces; ``band_width`` is the
    live width (``None``: W)."""
    emit_em = mode == EM
    mea = mode in (DECODE, DECODE_GAMMA)
    want_gamma = mode in (GAMMA, DECODE_GAMMA)
    emit_exp = mode == EXP
    B, k_pad, W = xyc.shape
    wl = live_width(band_width, W)
    dev = xyc.device
    f32 = torch.float32
    tab = kernel_tables(params).to(dev)
    tf = tab[:25].reshape(5, 5)  # [from, to]
    emf = tab[25:61]
    egf = tab[61:91]
    tfT = tf.t().contiguous()  # [to, from]
    gg = float(np.float32(gap_gamma))
    mg = float(np.float32(match_gamma))
    kend = (m.to(torch.int64) + n.to(torch.int64))
    base = torch.arange(W, device=dev) + 1
    w0 = torch.zeros(W, dtype=torch.bool, device=dev)
    w0[0] = True
    live = torch.arange(W, device=dev) < wl
    codes = xyc.to(torch.int32) & 0xFF
    ones = torch.ones(B, dtype=f32, device=dev)
    pad0 = torch.zeros((B, NUM_STATES, 1), dtype=f32, device=dev)
    pad_neg = torch.full((B, 3, 1), NEG, dtype=f32, device=dev)
    # d1 (bit 6) of every diagonal, 0 past k_pad
    d1_all = torch.zeros((B, k_pad + 3), dtype=torch.int32, device=dev)
    d1_all[:, 1:k_pad + 1] = (codes[:, :, 0] >> 6) & 1
    emissions = _forward_lookups(codes, emf, egf, base)

    def em_bin_masks(k0, k1):
        """The bins of the EM sums of diagonals k0 .. k1 - 1 (>= 1):
        (B, n, 16, W), (B, n, 4, W) and (B, n, 4, W) masks, the match
        state's by (x, y), the delete states' by x, the insert states' by
        y (codes 0-3 only)."""
        c = codes[:, k0 - 1:k1 - 1]
        x = ((c >> 3) & 7)[:, :, None, :]
        y = (c & 7)[:, :, None, :]
        cell = torch.where((x < 4) & (y < 4), x * 4 + y, -1)
        return cell == bins16[:, None], x == bins4[:, None], y == bins4[:, None]

    def bwd_indices(k0, k1):
        """The backward's gather indices (B, n, 5, W) onto diagonals
        k0 .. k1 - 1 (>= 0), by the deltas d1n1, d1n2 of the two
        diagonals above each, and d1n1 (B, n)."""
        k1 = min(k1, k_pad + 1)
        d1n1 = d1_all[:, k0 + 1:k1 + 1]
        d1n2 = d1_all[:, k0 + 2:k1 + 2]
        d2n2 = d1n1 + d1n2 - 1
        S = torch.stack([-d2n2, 1 - d1n1, -d1n1, 1 - d1n1, -d1n1], dim=2)
        return base + S[..., None], d1n1

    em_bins = _by_chunk(em_bin_masks, 1, dev)
    bwd_index = _by_chunk(bwd_indices, 0, dev)

    # ---------------- forward ----------------
    F = torch.zeros((B, k_pad + 1, NUM_STATES, W), dtype=f32, device=dev)
    F[:, 0, :, 0] = 1.0 / NUM_STATES  # start tile: diagonal 0
    sfinv = torch.ones((B, k_pad + 2), dtype=f32, device=dev)
    prev = F[:, 0]
    prevprev = torch.zeros((B, NUM_STATES, W), dtype=f32, device=dev)
    rs = torch.ones(B, dtype=f32, device=dev)
    ls_hi = torch.zeros(B, dtype=f32, device=dev)
    ls_c = torch.zeros(B, dtype=f32, device=dev)
    acc = torch.zeros(B, dtype=f32, device=dev)
    fin_end = torch.ones(B, dtype=f32, device=dev)
    tiny = torch.tensor(1e-37, dtype=f32, device=dev)
    for k in range(1, k_pad + 1):
        rescale = k % 2 == 0
        # shifts (d1 + d1p - 1, d1 - 1, d1, d1 - 1, d1), as _shift takes
        E, idx = emissions(k)
        # destination 0 (match) takes the diagonal two back, the others
        # the diagonal one back; transitions summed before the shifts
        src = torch.cat([
            prevprev[:, None], prev[:, None].expand(B, 4, NUM_STATES, W)
        ], dim=1)
        T = _seq_sum(tfT[None, :, :, None] * src)
        Ts = _shift_at(T, idx, pad0)
        r = rs if not rescale else ones
        Ts = torch.cat([(Ts[:, 0] * r[:, None])[:, None], Ts[:, 1:]], dim=1)
        new = E * Ts
        if rescale:
            scale = new.amax(dim=(1, 2))
            safe = torch.where(scale > 0, scale, ones)
            inv = 1.0 / safe
            new = new * inv[:, None, None]
            y_ = torch.log(safe) - ls_c
            t_ = ls_hi + y_
            ls_c = (t_ - ls_hi) - y_
            ls_hi = t_
            sfinv[:, k] = inv
            rs = inv
        fin = new[:, 0, 0]
        for s in range(1, NUM_STATES):
            fin = fin + new[:, s, 0]
        is_end = kend == k
        fin_c = torch.maximum(fin, tiny)
        fin_end = torch.where(is_end, fin_c, fin_end)
        acc = torch.where(is_end, acc + (torch.log(fin_c) + (ls_hi - ls_c)),
                          acc)
        F[:, k] = new
        prevprev, prev = prev, new
    loglik = acc

    # ------- backward + reverse MEA, EM sums, gamma band or retire -------
    inv_fin = 1.0 / fin_end
    zeros_bw = torch.zeros((B, W), dtype=f32, device=dev)
    b1 = torch.zeros((B, NUM_STATES, W), dtype=f32, device=dev)
    b2 = torch.zeros((B, NUM_STATES, W), dtype=f32, device=dev)
    binv = torch.ones(B, dtype=f32, device=dev)
    g_next = torch.zeros(B, dtype=f32, device=dev)
    u1 = torch.full((B, W), NEG, dtype=f32, device=dev)
    u2 = u1.clone()
    gm1 = gm2 = gd1 = gi1 = zeros_bw
    # emissions of diagonal k+1 ([e_m, gx1, gy2, gx3, gy4]) and the
    # match emission of k+2; beyond the lattice they are zero
    E1 = torch.zeros((B, NUM_STATES, W), dtype=f32, device=dev)
    em2 = zeros_bw
    end_band = torch.zeros((NUM_STATES, W), dtype=f32, device=dev)
    end_band[:, 0] = 1.0
    end_u = torch.where(w0, 0.0, NEG).to(f32)
    if emit_em:
        L = em_lanes(W)  # lanes; each owns W / L adjacent band cells
        acc_t = torch.zeros((B, 25, L), dtype=f32, device=dev)
        acc_m = torch.zeros((B, 16, L), dtype=f32, device=dev)
        acc_d = torch.zeros((B, 8, L), dtype=f32, device=dev)  # states 1, 3 by x
        acc_i = torch.zeros((B, 8, L), dtype=f32, device=dev)  # states 2, 4 by y
        bins4 = torch.arange(4, device=dev)[None, :, None]
        bins16 = torch.arange(16, device=dev)[None, :, None]
        zero = torch.zeros((), dtype=f32, device=dev)
    if mea:
        dirs = torch.empty((B, k_pad + 1, W), dtype=torch.int8, device=dev)
    if want_gamma:
        gam_band = torch.empty((B, k_pad + 1, W), dtype=f32, device=dev)
    if emit_exp:
        thr = torch.tensor(float(np.float32(exp_threshold)), dtype=f32,
                           device=dev)
        acc_e = torch.zeros((B, 4, W), dtype=f32, device=dev)
        ret = torch.empty((B, k_pad + 1, 4), dtype=f32, device=dev)
        col0 = torch.zeros((B, 4, 1), dtype=f32, device=dev)
        bases = torch.arange(4, device=dev)[None, :, None]
        sentinel = torch.full((B, W), 5, dtype=torch.int32, device=dev)
    score = None
    for k in range(k_pad, -1, -1):
        rescale = k % 2 == 1 or k == 0
        # shifts (-d2n2, 1 - d1n1, -d1n1, 1 - d1n1, -d1n1) by the deltas
        # d1n1, d1n2 of diagonals k+1, k+2, with d2n2 = d1n1 + d1n2 - 1
        idx, d1n1 = bwd_index(k)
        P = torch.stack([
            b2[:, 0] * em2, b1[:, 1] * E1[:, 1], b1[:, 2] * E1[:, 2],
            b1[:, 3] * E1[:, 3], b1[:, 4] * E1[:, 4],
        ], dim=1)  # [M, D1, I1, D2, I2] destinations
        dest = _shift_at(P, idx, pad0)
        dest = torch.cat([(dest[:, 0] * binv[:, None])[:, None], dest[:, 1:]],
                         dim=1)
        new = _seq_sum(tf[None, :, :, None] * dest[:, None, :, :])
        is_end = kend == k
        new = torch.where(is_end[:, None, None], end_band[None], new)
        new = torch.where(live, new, 0.0)
        if rescale:
            scale = new.amax(dim=(1, 2))
            safe = torch.where(scale > 0, scale, ones)
            inv = 1.0 / safe
            new = new * inv[:, None, None]
        else:
            safe = inv = ones
        factor_trans = g_next * sfinv[:, k + 1]
        if emit_em:
            # xi_k[s, t] without its tf factor; ``dest`` is the value
            # before the end-cell overwrite, and g_next is 0 until the
            # read's own end diagonal has passed
            fs = F[:, k] * factor_trans[:, None, None]
            acc_t = _lane_add(
                acc_t,
                (fs[:, :, None, :] * dest[:, None, :, :]).reshape(B, 25, W),
            )
        g_k = torch.where(is_end, inv_fin, factor_trans * safe)
        g_k = torch.clamp(g_k, max=3e37)
        gamma = (F[:, k] * new) * g_k[:, None, None]
        if want_gamma:
            gam_band[:, k] = gamma[:, 0]
        if emit_exp:
            # retire column wl - 1, move the band up by d1[k+1] (a blend,
            # as the kernel writes it) within the live columns, bin
            # diagonal k's gamma_match
            d1f = d1n1.to(f32)[:, None, None]
            ret[:, k] = acc_e[:, :, wl - 1] * d1f[:, :, 0]
            sh = torch.cat([col0, acc_e[:, :, :W - 1]], dim=2)
            acc_e = torch.where(live, acc_e + d1f * (sh - acc_e), 0.0)
            g0 = gamma[:, 0]
            gmz = g0 * torch.where(g0 > thr, 1.0, 0.0).to(f32)
            y = (codes[:, k - 1] & 7) if k >= 1 else sentinel
            onehot = (y[:, None, :] == bases).to(f32)
            acc_e = acc_e + gmz[:, None, :] * onehot
        if emit_em:
            if k == 0:
                break  # diagonal 0 holds no base: nothing to bin
            m16, ohx, ohy = em_bins(k)
            acc_m = _lane_add(acc_m, torch.where(m16, gamma[:, 0:1], zero))
            acc_d = _lane_add(acc_d, torch.cat([
                torch.where(ohx, gamma[:, 1:2], zero),
                torch.where(ohx, gamma[:, 3:4], zero)], dim=1))
            acc_i = _lane_add(acc_i, torch.cat([
                torch.where(ohy, gamma[:, 2:3], zero),
                torch.where(ohy, gamma[:, 4:5], zero)], dim=1))
        elif mea:
            g_m = gamma[:, 0]
            g_d = gamma[:, 1] + gamma[:, 3]
            g_i = gamma[:, 2] + gamma[:, 4]
            V = torch.stack([(u2 + gm2) - mg, u1 + gg * gd1, u1 + gg * gi1],
                            dim=1)
            Vs = _shift_at(V, idx[:, :3], pad_neg)
            diag_t, left_t, up_t = Vs[:, 0], Vs[:, 1], Vs[:, 2]
            best = torch.maximum(torch.maximum(diag_t, left_t), up_t)
            choice = torch.where(
                best == diag_t, 0, torch.where(best == left_t, 1, 2)
            )
            new_u = torch.where(is_end[:, None], end_u[None],
                                torch.where(live, best, NEG))
            ok = (new_u > NEG / 2) & ~is_end[:, None]
            dirs[:, k] = torch.where(ok, choice, DIR_NONE).to(torch.int8)
            if k == 0:
                score = new_u[:, 0]
                break
            u2, u1 = u1, new_u
            gm2, gm1, gd1, gi1 = gm1, g_m, g_d, g_i
        elif k == 0:
            break
        b2, b1, binv, g_next = b1, new, inv, g_k
        em2 = E1[:, 0]
        E1 = emissions(k)[0]
    if mea:
        out = {"loglik": loglik, "score": score, "dirs": dirs}
        if want_gamma:
            out["gamma"] = gam_band
        return out
    if want_gamma:
        return {"loglik": loglik, "gamma": gam_band}
    if emit_exp:
        return {"loglik": loglik, "ret": ret, "flush": acc_e}
    trans = (tf.reshape(25)[None] * _lane_total(acc_t)).reshape(B, 5, 5)
    dele = _lane_total(acc_d) / 4.0  # (B, 8): state 1 by x, state 3 by x
    ins = _lane_total(acc_i) / 4.0
    emis = torch.stack([
        _lane_total(acc_m),
        dele[:, 0:4].repeat_interleave(4, dim=1),
        ins[:, 0:4].repeat(1, 4),
        dele[:, 4:8].repeat_interleave(4, dim=1),
        ins[:, 4:8].repeat(1, 4),
    ], dim=1)
    return {"loglik": loglik, "trans": trans, "emis": emis}


def untile(raw, B: int) -> np.ndarray:
    """The JAX package's lane-tiled layout (NB, ..., BT) -> batch-major
    (B, ...): read b sits in tile b // BT, lane b % BT."""
    arr = np.asarray(raw)
    NB, BT = arr.shape[0], arr.shape[-1]
    return np.moveaxis(arr, -1, 1).reshape((NB * BT,) + arr.shape[1:-1])[:B]
