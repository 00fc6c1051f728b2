"""Banded five-state Viterbi: the max-product forward over packed codes.

Counterpart of the host side of ``nanopore_tpu/ops/pairhmm_pallas_viterbi.py``
and of ``nanopore_tpu/ops/viterbi.py``: the extension decode of the
mapping engine's ``decode="viterbi"`` presets.  One pass over the
lattice in log space (no rescaling), emitting one backpointer cell per
band cell per diagonal; ``ops.traceback.viterbi_walk`` walks the plane
into op codes.

Two planes, picked by the model's transition structure
(:func:`viterbi_structure_ok`):

* the byte plane (int8), for a model in the canonical fiveState
  structure, where each gap state is entered only from match or itself
  (every shipped model, and every model EM trains from one):
  ``p = bM + 5 * (tD1 + 2 tI1 + 4 tD2 + 8 tI2)``, the match state's
  predecessor state and, for each gap state, whether it came from itself
  (``t = bp != 0``).  Its tables (:func:`viterbi_tables`) put the
  structure zeros at ``NEG`` (never log(1e-37), which could win an
  argmax from a much better predecessor), as the JAX package's Pallas
  kernel does, to the bit;
* the full plane (int16), for any other model: ``p = sum_s b_s << 3s``,
  the predecessor state (0-4) of each of the five states.  Its tables
  (:func:`viterbi_full_tables`) take ``log(max(t, 1e-37))`` of every
  transition, as the JAX package's XLA scan (``viterbi_decode_batch``),
  which serves such a model there, does: a structure zero is about
  -85.2 and may decide a cell.

Numerics, shared by the kernel (``csrc/viterbi.cu``) and the plain
version below, operation for operation:

* log tables computed in float32 with numpy, log emissions floored at
  1e-37;
* for each destination state the max and argmax over its 5 predecessor
  states (``pred + ltf[s * 5 + dest]``, a tie keeps the lower state, as
  ``jnp.argmax``), taken BEFORE the band shift: the match state reads
  diagonal k - 2 shifted by d2, the delete states k - 1 by d1 - 1, the
  insert states k - 1 by d1; shifted-in cells are ``NEG`` with
  backpointer 0 (the scan's shift-then-max gives the same there: every
  candidate is ``NEG + log t``, which rounds to ``NEG``);
* the byte plane's short step takes a gap destination's max over its
  two allowed predecessors (match and itself) alone, the same values and
  bits where every gap state has t[match -> g] > 0 or t[g -> g] > 0
  (:func:`short_step`; ``csrc/viterbi.cu`` gives the argument); a model
  with a gap state that neither enters takes its 5-way step;
* then the emission is added and the sum clamped at ``NEG``; a cell whose
  x (or y) code is the sentinel 5 emits ``NEG`` (N = 4 is a real code).
  Off the lattice that gives the scan's ``NEG`` mask, and on its
  boundary cells (j = 0 or i = 0), whose sentinel the scan reads as an
  N, both give ``NEG``: their predecessors lie off the lattice;
* at band cell 0 of diagonal k_end = m + n, the score is the max over
  the 5 states and ``fstate`` its argmax (strict ``>``);
* diagonal 0 holds float32(log(1/5)) in cell 0 of every state, ``NEG``
  elsewhere.

The full plane's arithmetic is the scan's, so with the scan's tables it
gives the scan's scores and backpointers bit for bit; the scan takes
each log with XLA's ``log``, which may round a table entry one ulp away
from numpy's (``tests/test_torch_viterbi_full.py`` counts them).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nanopore_tpu_torch.kernels import build as kb
from nanopore_tpu_torch.ops.pack import VITERBI_BAND_WIDTHS
from nanopore_tpu_torch.ops.pairhmm import KernelParams, kernel_tables
from nanopore_tpu_torch.ops.realign import _by_chunk, _check_inputs, _shift_at

NUM_STATES = 5
NEG = -1e30
FLOOR = 1e-37  # the log tables' floor
# the kernel's steps (csrc/viterbi.cu): the byte plane's 5-way and short
# steps, and the full plane's
FIVE_WAY, SHORT, FULL = 0, 1, 2

LAUNCHES = kb.LaunchCounter("viterbi")
FULL_LAUNCHES = kb.LaunchCounter("viterbi_full")
_SIG = {
    "np_viterbi_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 4,
    "np_viterbi_attrs": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def _log_tables(params: KernelParams, structure_zeros_at_neg: bool):
    tab = kernel_tables(params).numpy()
    tf, emf, egf = tab[:25], tab[25:61], tab[61:]
    ltf = np.log(np.maximum(tf, FLOOR))
    if structure_zeros_at_neg:
        ltf = np.where(tf > 0, ltf, NEG)
    return torch.from_numpy(np.concatenate([
        ltf.astype(np.float32),
        np.log(np.maximum(emf, FLOOR)).astype(np.float32),
        np.log(np.maximum(egf, FLOOR)).astype(np.float32),
    ]))


def viterbi_tables(params: KernelParams) -> torch.Tensor:
    """(91,) f32 CPU tensor of the byte plane's log tables: transitions
    (25, structure zeros at ``NEG``) | match emissions (6, 6) (36) | gap
    emissions (5, 6) (30), in the layout of ``ops.pairhmm.kernel_tables``.

    Derived anew from all three tables at every call: no cache keyed on
    a table's identity.
    """
    return _log_tables(params, True)


def viterbi_full_tables(params: KernelParams) -> torch.Tensor:
    """(91,) f32 CPU tensor of the full plane's log tables: those of
    :func:`viterbi_tables` with every transition ``log(max(t, 1e-37))``,
    a structure zero included (the XLA scan's)."""
    return _log_tables(params, False)


def viterbi_structure_ok(params: KernelParams) -> bool:
    """True when every gap state is entered only from match or itself
    (the canonical fiveState structure the byte plane represents); the
    full plane serves every other model."""
    t = params.t.detach().to("cpu", torch.float64).reshape(5, 5).numpy()
    for dest in range(1, NUM_STATES):
        for src in range(NUM_STATES):
            if src not in (0, dest) and t[src, dest] > 0:
                return False
    return True


def short_step(tables: torch.Tensor) -> bool:
    """True when the kernel may take its short step, each gap state's
    max over its two allowed predecessors (match and itself): every gap
    state g has t[match -> g] > 0 or t[g -> g] > 0.  Then one of the two
    candidates is at least NEG and a disallowed one can only tie it, so
    the max and the from-self bit are the 5-way step's
    (``csrc/viterbi.cu`` gives the argument).  Only a model with a gap
    state entered from nowhere (both transitions 0) takes the kernel's
    5-way step.  ``tables`` is :func:`viterbi_tables`' output of a model
    in the canonical structure.  Not a user switch: both steps give the
    same bytes where this holds."""
    lt = tables[:25].reshape(NUM_STATES, NUM_STATES)  # [src, dest]
    return all(bool(lt[0, g] > NEG) or bool(lt[g, g] > NEG)
               for g in range(1, NUM_STATES))


def kernel_attributes(W: int, step: int = SHORT) -> dict:
    """The compiled kernel's registers, local-memory (spill) bytes per
    thread, static and dynamic shared memory per block (its stage is
    dynamic at W = 768 and 1024, static below), and threads and reads per
    block at band width ``W`` (32, 64, 128, 256, 384, 512, 768 or 1024),
    for its ``step``
    (``SHORT``, ``FIVE_WAY`` or ``FULL``; needs the card: builds the
    kernel)."""
    lib = kb.library("viterbi", _SIG)
    vals = (ctypes.c_int * 6)()
    kb.check(lib, lib.np_viterbi_attrs(W, int(step), vals), "viterbi attrs")
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "dynamic_smem", "threads", "reads"), vals))


def viterbi_forward(xyc, m, n, params: KernelParams) -> dict:
    """Banded Viterbi over packed band codes.

    xyc (B, k_pad, W) int8, m / n (B,) int32 read / window lengths.
    Returns ``score`` (B,) f32, ``fstate`` (B,) int32 and ``bp``
    (B, k_pad + 1, W), row k = diagonal k (row 0 and the rows past a
    read's end diagonal hold zeros): the int8 byte plane for a model in
    the canonical structure, else the int16 full plane.  CUDA tensors
    launch the kernel, CPU tensors run the plain version.
    """
    _check_inputs(xyc, m, n)
    if xyc.device.type == "cpu":
        return viterbi_forward_plain(xyc, m, n, params)
    if viterbi_structure_ok(params):
        tables = viterbi_tables(params)
        return _launch(xyc, m, n, tables,
                       SHORT if short_step(tables) else FIVE_WAY)
    return _launch(xyc, m, n, viterbi_full_tables(params), FULL)


def _launch(xyc, m, n, tables, step: int) -> dict:
    """The kernel on CUDA tensors with log ``tables`` at its ``step``
    (:func:`viterbi_forward` picks it); one count per launch, on
    ``FULL_LAUNCHES`` for the full plane, else on ``LAUNCHES``."""
    B, k_pad, W = xyc.shape
    if W not in VITERBI_BAND_WIDTHS:
        raise ValueError("viterbi kernel serves W in %s, got %d"
                         % (VITERBI_BAND_WIDTHS, W))
    out = {
        "score": xyc.new_empty(B, dtype=torch.float32),
        "fstate": xyc.new_empty(B, dtype=torch.int32),
        "bp": xyc.new_empty((B, k_pad + 1, W), dtype=torch.int16
                            if step == FULL else torch.int8),
    }
    if B == 0:
        return out
    lib = kb.library("viterbi", _SIG)
    with torch.cuda.device(xyc.device):
        rc = lib.np_viterbi_launch(
            ctypes.c_void_p(tables.data_ptr()), kb.ptr(xyc), kb.ptr(m),
            kb.ptr(n), B, k_pad, W, int(step), kb.ptr(out["score"]),
            kb.ptr(out["fstate"]), kb.ptr(out["bp"]), kb.stream_of(xyc),
        )
    kb.check(lib, rc, "viterbi")
    (FULL_LAUNCHES if step == FULL else LAUNCHES).add()
    return out


def viterbi_forward_plain(xyc, m, n, params: KernelParams) -> dict:
    """The Viterbi in plain PyTorch, on the plane :func:`viterbi_forward`
    picks: the byte plane for a model in the canonical structure, else
    :func:`viterbi_forward_full_plain`."""
    if viterbi_structure_ok(params):
        return plain_forward(xyc, m, n, viterbi_tables(params), full=False)
    return viterbi_forward_full_plain(xyc, m, n, params)


def viterbi_forward_full_plain(xyc, m, n, params: KernelParams) -> dict:
    """The full plane in plain PyTorch, for any model: the XLA scan's
    arithmetic in its order, on :func:`viterbi_full_tables`."""
    return plain_forward(xyc, m, n, viterbi_full_tables(params), full=True)


# the full plane's field of each state: p = sum_s b_s << 3s
_FULL_SHIFTS = (0, 3, 6, 9, 12)
# the byte plane's weight of each gap state's from-self bit
_GAP_BITS = (0, 5, 10, 20, 40)


def plain_forward(xyc, m, n, tables: torch.Tensor, full: bool) -> dict:
    """The Viterbi recursion on log ``tables`` (:func:`viterbi_tables` or
    :func:`viterbi_full_tables`), vectorised over batch, states and band,
    one loop step per diagonal: the kernel's arithmetic in its order,
    writing the full plane (``full``) or the byte plane.  The emissions
    and the band shifts' gather indices are looked up many diagonals at
    a time (``ops.realign._by_chunk``), the bits of one at a time."""
    tab = tables.to(xyc.device)
    B, k_pad, W = xyc.shape
    dev = xyc.device
    f32 = torch.float32
    ltfT = tab[:25].reshape(5, 5).t().contiguous()  # [dest, src]
    lemf = tab[25:61]
    legf = tab[61:91]
    neg = torch.tensor(NEG, dtype=f32, device=dev)
    base = torch.arange(W, device=dev) + 1
    kend = m.to(torch.int64) + n.to(torch.int64)
    codes = xyc.to(torch.int32) & 0xFF
    prev = torch.full((B, NUM_STATES, W), NEG, dtype=f32, device=dev)
    prev[:, :, 0] = float(np.float32(np.log(1.0 / NUM_STATES)))  # diagonal 0
    prevprev = torch.full((B, NUM_STATES, W), NEG, dtype=f32, device=dev)
    score = torch.full((B,), NEG, dtype=f32, device=dev)
    fstate = torch.zeros(B, dtype=torch.int32, device=dev)
    bp = torch.zeros((B, k_pad + 1, W),
                     dtype=torch.int16 if full else torch.int8, device=dev)
    zero_i = torch.zeros((B, NUM_STATES, W), dtype=torch.int32, device=dev)
    weights = torch.tensor(_FULL_SHIFTS if full else _GAP_BITS,
                           dtype=torch.int32, device=dev)[None, :, None]

    def lookups(k0, k1):
        # diagonals k0 .. k1 - 1: the emissions (B, D, 5, W) and the
        # gather index (B, D, 5, W) of the shifts by (d2, d1 - 1, d1,
        # d1 - 1, d1)
        c = codes[:, k0 - 1:k1 - 1]
        x = (c >> 3) & 7
        y = c & 7
        top = c[:, :, 0]
        d1 = (top >> 6) & 1
        d2 = d1 + ((top >> 7) & 1) - 1
        okx = x < 5
        oky = y < 5
        xs = x.clamp(max=5)
        ys = y.clamp(max=5)
        emit = torch.where(
            torch.stack([okx & oky, okx, oky, okx, oky], dim=2),
            torch.stack([lemf[xs * 6 + ys], legf[6 + xs], legf[12 + ys],
                         legf[18 + xs], legf[24 + ys]], dim=2),
            neg)
        S = torch.stack([d2, d1 - 1, d1, d1 - 1, d1], dim=2)
        return emit, base + S[..., None]

    lookup = _by_chunk(lookups, 1, dev)
    neg_pad = torch.full((B, NUM_STATES, 1), NEG, dtype=f32, device=dev)
    zero_pad = torch.zeros((B, NUM_STATES, 1), dtype=torch.int32,
                           device=dev)
    for k in range(1, k_pad + 1):
        emit, idx = lookup(k)
        # candidates [b, dest, src, w]: the match state reads diagonal
        # k - 2, the gap states k - 1
        src = torch.cat([prevprev[:, None],
                         prev[:, None].expand(B, 4, NUM_STATES, W)], dim=1)
        cand = src + ltfT[None, :, :, None]
        v = cand[:, :, 0]
        b = zero_i
        for s in range(1, NUM_STATES):
            b = torch.where(cand[:, :, s] > v, s, b)
            v = torch.maximum(v, cand[:, :, s])
        v = _shift_at(v, idx, neg_pad)
        b = _shift_at(b, idx, zero_pad)
        new = torch.maximum(v + emit, neg)
        if full:  # p = bM + bD1 << 3 + bI1 << 6 + bD2 << 9 + bI2 << 12
            p = (b << weights).sum(dim=1)
        else:  # p = bM + 5 tD1 + 10 tI1 + 20 tD2 + 40 tI2
            p = b[:, 0] + ((b[:, 1:] != 0).to(torch.int32)
                           * weights[:, 1:]).sum(dim=1)
        bp[:, k] = p.to(bp.dtype)
        v_end = new[:, 0, 0]
        s_end = zero_i[:, 0, 0]
        for s in range(1, NUM_STATES):
            s_end = torch.where(new[:, s, 0] > v_end, s, s_end)
            v_end = torch.maximum(v_end, new[:, s, 0])
        is_end = kend == k
        score = torch.where(is_end, v_end, score)
        fstate = torch.where(is_end, s_end, fstate)
        prevprev, prev = prev, new
    # rows past each read's end diagonal are not part of its lattice
    rows = torch.arange(k_pad + 1, device=dev)[None, :]
    bp.masked_fill_((rows > kend[:, None])[:, :, None], 0)
    return {"score": score, "fstate": fstate, "bp": bp}
