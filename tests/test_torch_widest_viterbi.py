"""The Viterbi and forward-only path at band widths 257 to 512 in the
port's W = 384 and W = 512 layouts, on the CPU, against the JAX
package's XLA-scan route at the same width.

A band of live width 256 < w <= 384 lies in the first w lanes of
W = 384 lanes, and 384 < w <= 512 in W = 512 (``ops.pack.padded_width``),
its dead lanes all sentinel, on either device.  On the card the Viterbi
kernel (both planes) and the forward-only kernel hold it on a group of
three or four warps and the Viterbi walker walks it (one read a block;
the full plane's 16-bit rows in chunks of 64 diagonals); these tests run
their plain versions, with tests/test_torch_wide_viterbi.py's checks.
tests/test_torch_widest.py holds the MEA path at these widths.  At
w = 300 (dead lanes in the top warp of W = 384), 384 (none), 450 (in
W = 512) and 512 (none), on tests/test_torch_widths.py's reads:

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
* at w = 300 and 450, the padded layout: the Viterbi's score, fstate
  and both planes' live lanes, the walkers' ops and end cells and the
  forward loglik, bit for bit what the plain versions give on the
  unpadded band;
* ``MappingEngine(band_width=450, decode="viterbi")``: records equal to
  the JAX engine's at the same width;
* on random codes at w = 300 and 450 no Viterbi walk leaves the live
  band, on either plane;
* the forward-only kernel's group vote (csrc/forward.cu at W = 384 and
  512): on reads whose first delete state emits an N with NaN, the
  two-term sum's check first fails, chunk by chunk, in the top warp's
  cells alone (256-299 at w = 300, 384-449 at w = 450), and a model of
  the kernel's switch whose check spans the whole band (the group's
  vote) gives the plain version's bits;
* a switch at the group's band maximum: in 512 lanes, reads with runs
  of N under N emissions of 1e-37 switch mid-read and the model of the
  kernel's switch ends each with the plain version's finite bits;
* the walker's ring (csrc/walk.cuh): a numpy model of the Viterbi
  walker's chunking at 64 diagonals a chunk, the full plane's at
  W = 384 and 512, on full planes at W = 512 spanning many chunks, gives
  the plain walker's ops and end cells, whatever the ring held before;
* the width guard without a card: every Viterbi entry point takes 257,
  300, 384 and 512 past the guard, and twice each (514, 600, 768 and
  1024: since ROADMAP C11's sixth step, tests/test_torch_w1024_viterbi.py
  holds 513 to 1024), and refuses 1025 and 2048 naming C11, its message
  giving the Viterbi path's 2 to 1024 (the MEA path's 2 to 2048 since
  the seventh step).
"""

import numpy as np
import pytest
import torch

from nanopore_tpu_torch.ops import viterbi as V
from nanopore_tpu_torch.ops.forward import forward_loglik_plain, two_term_sum
from nanopore_tpu_torch.ops.pack import (
    KERNEL_BAND_WIDTHS,
    check_band_width,
    padded_width,
)
from nanopore_tpu_torch.ops.pairhmm import kernel_tables
from nanopore_tpu_torch.ops.traceback import viterbi_walk_plain
from test_torch_forward import _bits, _model_run
from test_torch_viterbi_full import both_params, full_pairs
from test_torch_wide import _past_the_guard, _viterbi_entry_points
from test_torch_wide_viterbi import (
    _case,
    engine_matches_jax,
    forward_matches_jax,
    full_plane_matches_jax,
    no_walk_leaves_the_live_band,
    padded_gives_unpadded,
    viterbi_matches_jax,
)
from test_torch_wider import viterbi_entry_points_take
from test_torch_wider_viterbi import (  # noqa: F401
    _finite_switch_case,
    _pair_vote_case,
    one_thread,
)
from test_torch_widths import _packed, _params, width_pairs

WIDEST = (300, 384, 450, 512)  # dead lanes in W = 384; none; in 512; none
PADDED = (300, 450)
# runs of N long enough for a band of 512: (length, start, run length),
# as chip_smoke.py's N_RUNS_WIDEST
N_RUNS_WIDEST = ((1200, 300, 500), (1120, 200, 520), (1000, 240, 460),
                 (1100, 300, 540), (1040, 0, 0))


@pytest.fixture(scope="module")
def pairs():
    return width_pairs()


@pytest.fixture(scope="module")
def layouts(pairs):
    return {w: _case(pairs, w) for w in WIDEST}


@pytest.fixture(scope="module")
def full_cases():
    jp, pp = both_params("i")
    pairs = full_pairs() + width_pairs()[:2]
    return pairs, jp, pp, {w: _case(pairs, w) for w in WIDEST}


@pytest.mark.parametrize("w", WIDEST)
def test_viterbi_matches_viterbi_decode_batch(pairs, layouts, w):
    """Score <= 1e-5 relative, fstate and cigars identical."""
    viterbi_matches_jax(pairs, layouts, w)


@pytest.mark.parametrize("w", WIDEST)
def test_forward_loglik_matches_jax(layouts, w):
    """Loglik <= 1e-5 relative of ``forward_loglik``, under the default
    model (the kernel's two-term gap sum) and model (i) (its 5-way
    sum)."""
    forward_matches_jax(layouts, w)


@pytest.mark.parametrize("w", WIDEST)
def test_full_plane_matches_the_xla_scan(full_cases, w):
    """tests/test_torch_viterbi_full.py's bar at w: on the scan's own
    tables the scan's scores bit for bit, its fstates and backpointers;
    on the port's tables score 1e-5 relative, fstate, the plane on every
    lattice cell and the cigars identical."""
    full_plane_matches_jax(full_cases, w)


@pytest.mark.parametrize("w", PADDED)
def test_padded_layout_gives_the_unpadded_bits(full_cases, w):
    """Both planes: the live lanes of the plane and every other output
    bit for bit the unpadded band's (a dead lane's backpointer may be
    set: lane w reads lane w - 1 through a delete's shift; its value
    clamps to NEG and no walk visits it)."""
    padded_gives_unpadded(full_cases, w)


def test_viterbi_engine_matches_the_jax_engine_at_450(tmp_path):
    """``MappingEngine(band_width=450, decode="viterbi")`` on the CPU:
    every record equal to the JAX engine's at the same width (its XLA
    scan), field by field."""
    engine_matches_jax(tmp_path, 450)


@pytest.mark.parametrize("w", PADDED)
def test_no_viterbi_walk_leaves_the_live_band_on_random_codes(w):
    """Unrelated random sequences under random guides at w: the paths
    press on the band's edges, and no walk on either plane leaves lanes
    0..w-1 of its padded layout."""
    no_walk_leaves_the_live_band(w)


# ---- the forward-only kernel's group vote (W = 384 and 512) -------------- #

@pytest.mark.parametrize("w", PADDED)
def test_the_group_vote_fails_the_top_warp_alone_and_keeps_the_plain_bits(w):
    """In each N read the NaN state starts in the top warp's live cells
    (256..w-1 of 384 at w = 300, 384..w-1 of 512 at w = 450) and spreads
    down about half a cell a diagonal, so the first chunk of 64
    diagonals with a non-finite gap state in the two-term recursion has
    one in the top warp's cells and none in the warps below: a vote per
    warp would keep their two-term chunk while the top warp reran it.
    The model of the kernel's switch, whose check spans the whole band
    (the group's vote), sends each N read to the 5-way sum from that
    chunk's start and gives the plain version's bits (NaN once the NaN
    reaches the end cell); the N-free read keeps the two-term sum and
    its finite loglik."""
    pairs, pp = _pair_vote_case(w)
    _, xyc, m, n = _packed(pairs, w, padded_width(w))
    top = xyc.shape[2] - 128  # the top warp's first cell
    assert top < w and two_term_sum(kernel_tables(pp))
    want = forward_loglik_plain(xyc, m, n, pp)
    ll, _, _, switched = _model_run(xyc, m, n, pp, "switch")
    assert torch.equal(_bits(ll), _bits(want))
    assert torch.isnan(want[:-1]).all() and torch.isfinite(want[-1])
    _, states, _, _ = _model_run(xyc, m, n, pp, "two")
    bad = ~torch.isfinite(torch.stack(states)[:, :, 1:])  # (k, B, 4, W)
    for b in range(len(pairs) - 1):
        chunk = next(c for c in range(0, len(states), 64)
                     if bad[c:c + 64, b].any())
        assert not bad[chunk:chunk + 64, b, :, :top].any()
        assert bad[chunk:chunk + 64, b, :, top:w].any()
        assert switched[b] == chunk + 1
    assert switched[-1] == -1 and not bad[:, -1].any()


def test_a_switch_at_the_groups_band_maximum_ends_finite_with_the_plain_bits():
    """In 512 lanes the band maximum of three N-run reads falls below
    FLT_MIN mid-read (a check every warp fails, the maximum being the
    group's); the model of the kernel's switch sends each from that
    chunk's start to the 5-way sum and ends with the plain version's
    bits, every loglik finite: the rollback and the 5-way sum after it
    are held where the result is a number."""
    pairs, pp = _finite_switch_case(N_RUNS_WIDEST)
    _, xyc, m, n = _packed(pairs, 512, 512)
    assert two_term_sum(kernel_tables(pp))
    want = forward_loglik_plain(xyc, m, n, pp)
    ll, _, _, switched = _model_run(xyc, m, n, pp, "switch")
    assert torch.equal(_bits(ll), _bits(want))
    assert torch.isfinite(want).all()
    kend = (m + n).long()
    mid = ((switched > 1) & (switched < kend)).tolist()
    assert mid == [True, False, True, True, False]
    assert ((switched[mid] - 1) % 64 == 0).all()


# ---- the walker's ring (csrc/walk.cuh) ----------------------------------- #

NBUF, OFF = 3, 4  # walk.cuh's ring depth and o[]'s margin
# walk.cuh's chunk<W, T>(): 64 diagonals where a row is more than 512
# bytes (the full plane at W = 384 and 512), else 128
FULL_CHUNK = 64


def _ring_walk(bp, xyc, m, n, fstate, ch, rng):
    """A numpy model of csrc/viterbi_traceback.cu's walk over walk.cuh's
    ring of NBUF chunks of ``ch`` diagonals, going down: the chunks
    staged NBUF - 1 ahead, each chunk's band offsets from one scan of
    its code words carried down from o[kstart], the lane's software-
    pipelined walk reading the ring and o[] only, and one op row a
    chunk.  The ring, the code words and o[] start with ``rng``'s
    garbage, which the walk must never read.  Returns ops and end
    cells as ``viterbi_walk_plain`` does."""
    B, K1, W = bp.shape
    k_pad = K1 - 1
    full = bp.dtype == np.int16
    codes = xyc.astype(np.int64) & 0xFF
    ops = np.full((B, K1), -1, np.int64)
    end = np.zeros((B, 2), np.int64)
    for r in range(B):
        i, j, s = int(m[r]), int(n[r]), int(fstate[r])
        walks = i + j <= k_pad
        kstart = i + j if walks else k_pad
        ctop = kstart // ch
        rows = rng.integers(0, 2 ** 15, (NBUF, ch, W))
        code = rng.integers(0, 256, (NBUF, ch))
        o = rng.integers(-10 ** 6, 10 ** 6, OFF + ch + OFF)

        def rows_of(c):
            return min(ch, kstart + 1 - c * ch) if c >= 0 else 0

        def stage(c, slot):
            lo = c * ch
            for t in range(rows_of(c)):
                rows[slot, t] = bp[r, lo + t]
                if lo + t >= 1:
                    code[slot, t] = codes[r, lo + t - 1, 0]

        ops[r, kstart + 1:] = 3
        for q in range(NBUF - 1):
            stage(ctop - q, q)
        otop = int(((codes[r, :kstart, 0] >> 6) & 1).sum())
        k = kstart
        for q in range(ctop + 1):
            c, slot = ctop - q, q % NBUF
            stage(c - (NBUF - 1), (q + NBUF - 1) % NBUF)
            lo, nrows = c * ch, rows_of(c)
            bits = [(int(code[slot, t]) >> 6) & 1
                    if t < nrows and lo + t >= 1 else 0 for t in range(ch)]
            incl = np.cumsum(bits)
            otop -= int(incl[-1])  # o[lo - 1]
            o[OFF:OFF + ch] = otop + incl
            row = np.full(ch, 3)
            if walks and k >= lo and (i, j) != (0, 0):
                kk = k - lo
                b0 = j - o[OFF + kk]
                p = int(rows[slot, kk, b0]) if 0 <= b0 < W else 0
                om1, om2 = o[OFF + kk - 1], o[OFF + kk - 2]
                while True:
                    o3, o4 = o[OFF + kk - 3], o[OFF + kk - 4]
                    is_m, is_d = s == 0, s in (1, 3)
                    row[kk] = 0 if is_m else (1 if is_d else 2)
                    i -= not is_d
                    j -= is_m or is_d
                    kn = kk - (2 if is_m else 1)
                    bn = j - (om2 if is_m else om1)
                    pn = (int(rows[slot, kn, bn])
                          if kn >= 0 and 0 <= bn < W else 0)
                    if full:
                        s = (p >> (3 * s)) & 7
                    else:
                        s = p % 5 if is_m else s * (((p // 5) >> (s - 1)) & 1)
                    om1, om2 = (o3, o4) if is_m else (om2, o3)
                    kk, p = kn, pn
                    if kk < 0 or (i == 0 and j == 0):
                        break
                k = lo + kk
            ops[r, lo:lo + nrows] = row[:nrows]
        end[r] = (i, j)
    return ops, end


@pytest.mark.parametrize("plane", ["viterbi", "random"])
def test_the_walkers_ring_of_64_diagonals_gives_the_plain_walk(plane):
    """Full planes at W = 512 (w = 450): the Viterbi's under model (i),
    whose walks reach the origin, and a random one (every field a random
    state, random end states, one read's m past k_pad), whose walks end
    short or leave the band.  Each spans 10 or more chunks of 64, and
    the ring model gives the plain walker's ops and end cells bit for
    bit."""
    rng = np.random.default_rng(64)
    pairs = full_pairs() + width_pairs()[:2]
    _, xyc, m, n = _packed(pairs, 450, padded_width(450))
    B, k_pad, W = xyc.shape
    assert W == 512 and k_pad >= 10 * FULL_CHUNK
    if plane == "viterbi":
        out = V.viterbi_forward_full_plain(xyc, m, n, both_params("i")[1])
        bp, fstate = out["bp"], out["fstate"]
    else:
        fields = rng.integers(0, 5, (B, k_pad + 1, W, 5))
        bp = torch.from_numpy(
            (fields << np.array([0, 3, 6, 9, 12])).sum(-1).astype(np.int16))
        fstate = torch.from_numpy(rng.integers(0, 5, B).astype(np.int32))
        m = m.clone()
        m[0] = k_pad + 1 - n[0]
    assert bp.dtype == torch.int16
    want_ops, want_end = viterbi_walk_plain(bp, xyc, m, n, fstate)
    ops, end = _ring_walk(bp.numpy(), xyc.numpy(), m.numpy(), n.numpy(),
                          fstate.numpy(), FULL_CHUNK, rng)
    np.testing.assert_array_equal(ops, want_ops.numpy())
    np.testing.assert_array_equal(end, want_end.numpy())
    if plane == "viterbi":
        assert not want_end.any()
    else:
        assert want_end.any(1).sum() >= 2


# ---- the width guard (ROADMAP C11), without a card ----------------------- #

@pytest.mark.parametrize("w", [257, 300, 384, 512])
def test_viterbi_entry_points_take_257_to_512_past_the_guard(w, monkeypatch):
    """``MappingEngine(decode="viterbi")``, ``PreparedViterbi`` and
    ``PreparedForward`` take w past the guard on the card, and 2 w too
    (514 to 1024: the Viterbi path's layouts are the MEA path's, to 1024
    since ROADMAP C11's sixth step; to 512 before it)."""
    assert padded_width(w) in KERNEL_BAND_WIDTHS[4:6]
    assert padded_width(2 * w) in KERNEL_BAND_WIDTHS[6:]
    viterbi_entry_points_take(w, monkeypatch)
    viterbi_entry_points_take(2 * w, monkeypatch)


@pytest.mark.parametrize("w", [1025, 2048])
def test_the_viterbi_path_refuses_513_and_above_naming_c11(w, monkeypatch):
    """The name keeps the width this test once refused: above 512 until
    ROADMAP C11's sixth step, above 1024 since.  Every Viterbi entry
    point refuses the band on the card before any work (no pack), naming
    C11, and the message gives the Viterbi path's 2 to 1024 beside the
    MEA path's 2 to 2048 (since the seventh step); the CPU serves it."""
    monkeypatch.setattr("nanopore_tpu_torch.ops.dispatch.pack_stream_pairs",
                        _past_the_guard)
    for name, call in _viterbi_entry_points(w).items():
        with pytest.raises(ValueError, match="C11") as err:
            call()
        assert ("the MEA path's kernels take widths 2 to 2048 and the "
                "Viterbi path's 2 to 1024") in str(err.value), name
    check_band_width(w, "cpu")
