"""Analytic flank contributions for EM on windowed global alignments.

The reference trains its HMM on CHAINED GLOBAL alignments — every read's
cigar spans the whole reference (utils.py:491-501) — and bounds the DP
cost with ``--splitMatrixBiggerThanThis=300`` matrix splitting
(reference nanopore/analyses/utils.py:509-523).  Realign and the
SNP caller here window each global record to its aligned ref span
(align.realign.window_global_pair), but EM could not: the flanking
pure-deletion runs carry real Baum-Welch mass (one D transition + one
delete-state emission per flanked ref base) that the M-step must see, or
the trained model's delete dwell probabilities collapse.

This module computes that flank mass in closed form so EM can train on
windowed lattices in bounded memory.  In the full banded lattice a flank
is a pure-deletion CORRIDOR: at read offset 0 (left flank) or m (right
flank) only the two delete states can advance, so the flank reduces to
an exact 2-state inhomogeneous HMM over the flank bases — O(flank) time
with a 5-word state, instead of O(flank * W * 5) lattice work and
device-memory diagonals on the card.

Boundary conditions use an overlap-subtraction ("Ext − Stub") scheme:

  correction_left  = C(x[0:a0],  entry=start) − C(x[g0:a0], entry=start)
  correction_right = C(x[a1:n],  entry=ones)  − C(x[a1:g1], entry=ones)

where [a0, a1) is the aligned ref span, [g0, g1) the window kept for the
device lattice (a0 − g0 = right-sized stub = ``pad``), C(·) the corridor
forward/backward expected counts, which run in the native library
(runtime.native_index.flank_corridor), the only route: a failed build or
load raises.  The window lattice itself computes
stub counts with a fresh start distribution at g0; the Stub term
subtracts exactly that and the Ext term replaces it with the true
corridor from position 0.  Unknown junction profiles (the backward
messages at a0, the forward profile at a1) appear IDENTICALLY in both
terms of each difference and cancel up to O(rho^pad), rho the corridor
mixing rate — so the scheme converges exponentially in ``pad`` to the
full-lattice expectations.

What is knowingly neglected: paths that consume READ bases deep in the
flank (the band admits ~W/2 of them).  Their transition structure is
equivalent to in-window consumption and their posterior mass beyond the
pad is tiny.
"""

from __future__ import annotations

import numpy as np

from nanopore_tpu_torch.align.model import NUM_STATES, PairHmmModel
from nanopore_tpu_torch.io.sam import CIG as _C
from nanopore_tpu_torch.runtime.native_index import flank_corridor


def flank_lengths(cigar) -> tuple[int, int]:
    """(lead, tail) pure-deletion run lengths of a global guide cigar."""
    lead = 0
    i = 0
    while i < len(cigar) and cigar[i][0] in (_C.D, _C.N):
        lead += cigar[i][1]
        i += 1
    if i == len(cigar):  # degenerate: all-deletion guide
        return lead, 0
    tail = 0
    j = len(cigar)
    while j > i and cigar[j - 1][0] in (_C.D, _C.N):
        tail += cigar[j - 1][1]
        j -= 1
    return lead, tail


def corridor_tables(model: PairHmmModel) -> tuple[np.ndarray, np.ndarray]:
    """(T (5,5), eg (5,5)) linear-space tables for the corridor.

    ``eg[state, base]`` are the per-state single-base gap emissions with
    the N column marginalised uniformly, as ``make_kernel_params``
    does for the kernels."""
    t = np.asarray(model.transitions, np.float64)
    gap = np.asarray(model.gap_emissions(), np.float64)  # (5, 4)
    eg = np.zeros((NUM_STATES, 5))
    eg[:, :4] = gap
    eg[:, 4] = gap.mean(axis=1)
    return t, eg


_START = np.full(NUM_STATES, 1.0 / NUM_STATES)  # oracle start distribution
_ONES = np.ones(NUM_STATES)


def em_flank_correction(
    x: np.ndarray,
    cigar,
    pad: int,
    t: np.ndarray,
    eg: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Ext − Stub flank correction for one windowed global pair.

    ``x`` is the FULL reference codes, ``cigar`` the full global guide;
    ``pad`` must equal the window pad used to build the device lattice
    (align.realign.window_global_pair).  Returns (trans (5,5),
    emis (5,16), dloglik) to ADD to the windowed lattice's E-step
    output under the model whose corridor tables are (t, eg).
    """
    n = len(x)
    lead, tail = flank_lengths(cigar)
    a0, a1 = lead, n - tail
    g0, g1 = max(0, lead - pad), min(n, n - tail + pad)
    trans = np.zeros((NUM_STATES, NUM_STATES))
    emis = np.zeros((NUM_STATES, 16))
    dll = 0.0
    if g0 > 0:
        et, ee, ez = flank_corridor(x[:a0], t, eg, _START)
        st, se, sz = flank_corridor(x[g0:a0], t, eg, _START)
        trans += et - st
        emis += ee - se
        dll += ez - sz
    if g1 < n:
        et, ee, ez = flank_corridor(x[a1:], t, eg, _ONES)
        st, se, sz = flank_corridor(x[a1:g1], t, eg, _ONES)
        trans += et - st
        emis += ee - se
        dll += ez - sz
    return trans, emis, dll
