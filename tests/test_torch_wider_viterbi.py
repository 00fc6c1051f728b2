"""The Viterbi and forward-only path at band widths 129 to 256 in the
port's W = 256 layout, on the CPU, against the JAX package's XLA-scan
route at the same width.

A band of live width 128 < w <= 256 lies in the first w lanes of W = 256
lanes (``ops.pack.padded_width``), its dead lanes all sentinel, on
either device; on the card the Viterbi kernel (both planes) and the
forward-only kernel hold it on a pair of warps and the Viterbi walker
walks it (two reads a block on the byte plane, one on the full plane);
these tests run their plain versions, with
tests/test_torch_wide_viterbi.py's checks.  tests/test_torch_wider.py
holds the MEA path at these widths.  At w = 200 (dead lanes 200..255)
and w = 256 (none), on tests/test_torch_widths.py's reads:

* the byte-plane Viterbi (the default model): score within 1e-5
  relative of ``viterbi_decode_batch``, fstate identical, and the
  walker's cigars equal to ``viterbi_traceback``'s for every read;
* the full plane under tests/test_torch_viterbi_full.py's model (i):
  that file's bar (on the scan's own log tables the scan's scores bit
  for bit, its fstates and backpointers; on the port's tables score
  1e-5 relative, fstate, plane on every lattice cell and cigars
  identical);
* the forward-only loglik within 1e-5 relative of the JAX package's
  ``forward_loglik``, under both gap sums' models;
* at w = 200, the padded layout: the Viterbi's score, fstate and both
  planes' live lanes, the walkers' ops and end cells and the forward
  loglik, bit for bit what the plain versions give on the unpadded band
  of width 200;
* ``MappingEngine(band_width=200, decode="viterbi")``: records equal to
  the JAX engine's at the same width;
* on random codes at w = 200 no Viterbi walk leaves the live band, on
  either plane;
* the forward-only kernel's pair vote (csrc/forward.cu at W = 256): on
  reads whose first delete state emits an N with NaN, the two-term
  sum's check first fails, chunk by chunk, in the upper warp's cells
  alone, and a model of the kernel's switch whose check spans the whole
  band (the pair's vote) gives the plain version's bits;
* a switch at the pair's band maximum: in 256 lanes, reads with runs of
  N under N emissions of 1e-37 switch mid-read and the model of the
  kernel's switch ends each with the plain version's finite bits.
"""

import numpy as np
import pytest
import torch

from nanopore_tpu_torch.io.sam import CIG
from nanopore_tpu_torch.ops.forward import forward_loglik_plain, two_term_sum
from nanopore_tpu_torch.ops.pack import padded_width
from nanopore_tpu_torch.ops.pairhmm import kernel_tables, params_from_numpy
from test_torch_forward import _bits, _model_run
from test_torch_viterbi_full import both_params, full_pairs
from test_torch_wide_viterbi import (
    _case,
    engine_matches_jax,
    forward_matches_jax,
    full_plane_matches_jax,
    no_walk_leaves_the_live_band,
    padded_gives_unpadded,
    viterbi_matches_jax,
)
from test_torch_widths import _packed, _params, width_pairs

WIDER = (200, 256)  # dead lanes 200..255; none


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions' per-diagonal ops on 256 lanes cross torch's
    grain for intra-op threads; one thread is faster here, and keeps a
    worker of a parallel run from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pairs():
    return width_pairs()


@pytest.fixture(scope="module")
def layouts(pairs):
    return {w: _case(pairs, w) for w in WIDER}


@pytest.fixture(scope="module")
def full_cases():
    jp, pp = both_params("i")
    pairs = full_pairs() + width_pairs()[:2]
    return pairs, jp, pp, {w: _case(pairs, w) for w in WIDER}


@pytest.mark.parametrize("w", WIDER)
def test_viterbi_matches_viterbi_decode_batch(pairs, layouts, w):
    """Score <= 1e-5 relative, fstate and cigars identical."""
    viterbi_matches_jax(pairs, layouts, w)


@pytest.mark.parametrize("w", WIDER)
def test_forward_loglik_matches_jax(layouts, w):
    """Loglik <= 1e-5 relative of ``forward_loglik``, under the default
    model (the kernel's two-term gap sum) and model (i) (its 5-way
    sum)."""
    forward_matches_jax(layouts, w)


@pytest.mark.parametrize("w", WIDER)
def test_full_plane_matches_the_xla_scan(full_cases, w):
    """tests/test_torch_viterbi_full.py's bar at w: on the scan's own
    tables the scan's scores bit for bit, its fstates and backpointers;
    on the port's tables score 1e-5 relative, fstate, the plane on every
    lattice cell and the cigars identical."""
    full_plane_matches_jax(full_cases, w)


def test_padded_layout_gives_the_unpadded_bits_at_200(full_cases):
    """Both planes at w = 200: the live lanes of the plane and every
    other output bit for bit the unpadded band's (a dead lane's
    backpointer may be set: lane 200 reads lane 199 through a delete's
    shift; its value clamps to NEG and no walk visits it)."""
    padded_gives_unpadded(full_cases, 200)


def test_viterbi_engine_matches_the_jax_engine_at_200(tmp_path):
    """``MappingEngine(band_width=200, decode="viterbi")`` on the CPU:
    every record equal to the JAX engine's at the same width (its XLA
    scan), field by field."""
    engine_matches_jax(tmp_path, 200)


def test_no_viterbi_walk_leaves_the_live_band_on_random_codes():
    """Unrelated random sequences of 250-460 bases under random guides
    at w = 200: the paths press on the band's edges, and no walk on
    either plane leaves lanes 0..199 of its 256."""
    no_walk_leaves_the_live_band(200)


# ---- the forward-only kernel's pair vote (W = 256) ----------------------- #

def _pair_vote_case(w=200, at=(100, 150, 200, 240, 280)):
    """Reads of w + 300 bases against their windows, each but the last
    with one N in its window where it enters the live band of width w at
    its top (w + ``at``: w + 100 to w + 280), under the default model
    with the first delete state's emission of an N at NaN (as
    chip_smoke.py's pair vote case)."""
    rng = np.random.default_rng(17)
    pairs = []
    L = w + 300
    for pos in [w + a for a in at] + [None]:
        x = rng.integers(0, 4, L).astype(np.int8)
        y = np.where(rng.random(L) < 0.08, rng.integers(0, 4, L),
                     x).astype(np.int8)
        if pos is not None:
            x[pos] = 4
        pairs.append((x, y, [(CIG.M, L)]))
    pp = _params()
    eg = pp.e_gap_flat.numpy().reshape(5, 5).copy()
    eg[1, 4] = np.nan
    return pairs, params_from_numpy(pp.t, pp.e_match_flat, eg.reshape(-1))


def test_the_pair_vote_fails_the_upper_warp_alone_and_keeps_the_plain_bits():
    """In each N read the NaN state starts in the upper warp's cells
    (128..199) and spreads at most one cell a diagonal, so the first
    chunk of 64 diagonals with a non-finite gap state in the two-term
    recursion has one in the upper warp's cells and none in the lower
    warp's: a vote per warp would keep the lower half's two-term chunk
    while the upper half reran it.  The model of the kernel's switch,
    whose check spans the whole band (the pair's vote), sends each N
    read to the 5-way sum from that chunk's start and gives the plain
    version's bits (NaN once the NaN reaches the end cell); the N-free
    read keeps the two-term sum and its finite loglik."""
    pairs, pp = _pair_vote_case()
    _, xyc, m, n = _packed(pairs, 200, padded_width(200))
    assert xyc.shape[2] == 256 and two_term_sum(kernel_tables(pp))
    want = forward_loglik_plain(xyc, m, n, pp)
    ll, _, _, switched = _model_run(xyc, m, n, pp, "switch")
    assert torch.equal(_bits(ll), _bits(want))
    assert torch.isnan(want[:-1]).all() and torch.isfinite(want[-1])
    _, states, _, _ = _model_run(xyc, m, n, pp, "two")
    bad = ~torch.isfinite(torch.stack(states)[:, :, 1:])  # (k, B, 4, W)
    for b in range(len(pairs) - 1):
        chunk = next(c for c in range(0, len(states), 64)
                     if bad[c:c + 64, b].any())
        assert not bad[chunk:chunk + 64, b, :, :128].any()
        assert bad[chunk:chunk + 64, b, :, 128:200].any()
        assert switched[b] == chunk + 1
    assert switched[-1] == -1 and not bad[:, -1].any()


N_RUNS_WIDER = ((600, 150, 250), (560, 100, 300), (640, 200, 220),
                (500, 120, 200), (520, 0, 0))


def _finite_switch_case(runs=N_RUNS_WIDER):
    """Reads with a run of N (chip_smoke.py's ``N_RUNS_WIDER`` by
    default, the last read none; (length, start, run length) each) under
    the default model with every emission of an N at 1e-37: the band
    maximum falls to a subnormal whose inverse is finite (as
    chip_smoke.py's finite switch case)."""
    rng = np.random.default_rng(0)
    pairs = []
    for L, p0, ln in runs:
        x = rng.integers(0, 4, L).astype(np.int8)
        y = x.copy()
        y[p0:p0 + ln] = 4
        pairs.append((x, y, [(CIG.M, L)]))
    pp = _params()
    em = pp.e_match_flat.numpy().reshape(5, 5).copy()
    eg = pp.e_gap_flat.numpy().reshape(5, 5).copy()
    em[:, 4] = em[4, :] = eg[:, 4] = np.float32(1e-37)
    return pairs, params_from_numpy(pp.t, em.reshape(-1), eg.reshape(-1))


def test_a_switch_at_the_pairs_band_maximum_ends_finite_with_the_plain_bits():
    """In 256 lanes the band maximum of three N-run reads falls below
    FLT_MIN mid-read (a check both warps fail, the maximum being the
    pair's); the model of the kernel's switch sends each from that
    chunk's start to the 5-way sum and ends with the plain version's
    bits, every loglik finite: the rollback and the 5-way sum after it
    are held where the result is a number."""
    pairs, pp = _finite_switch_case()
    _, xyc, m, n = _packed(pairs, 256, 256)
    assert two_term_sum(kernel_tables(pp))
    want = forward_loglik_plain(xyc, m, n, pp)
    ll, _, _, switched = _model_run(xyc, m, n, pp, "switch")
    assert torch.equal(_bits(ll), _bits(want))
    assert torch.isfinite(want).all()
    kend = (m + n).long()
    mid = ((switched > 1) & (switched < kend)).tolist()
    assert mid == [True, False, True, True, False]
    assert ((switched[mid] - 1) % 64 == 0).all()
