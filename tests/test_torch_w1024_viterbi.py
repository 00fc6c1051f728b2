"""The Viterbi and forward-only path at band widths 513 to 1024 in the
port's W = 768 and W = 1024 layouts, on the CPU, against the JAX
package's XLA-scan route at the same width.

A band of live width 512 < w <= 768 lies in the first w lanes of
W = 768 lanes, and 768 < w <= 1024 in W = 1024 (``ops.pack.padded_width``),
its dead lanes all sentinel, on either device.  On the card the Viterbi
kernel (both planes) and the forward-only kernel hold it on a group of
six or eight warps and the Viterbi walker walks it (one read a block;
the byte rows in chunks of 64 diagonals, the full plane's 16-bit rows
in chunks of 32); these tests run their plain versions, with
tests/test_torch_wide_viterbi.py's checks.  tests/test_torch_w1024.py
holds the MEA path at these widths.  At w = 600 (in W = 768, whose top
warp holds dead lanes alone), 768 (none), 900 (in W = 1024, one live
lane in the top warp) and 1024 (none), on tests/test_torch_widths.py's
reads:

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
* at w = 600 and 900, the padded layout: the Viterbi's score, fstate
  and both planes' live lanes, the walkers' ops and end cells and the
  forward loglik, bit for bit what the plain versions give on the
  unpadded band;
* ``MappingEngine(band_width=900, decode="viterbi")``: records equal to
  the JAX engine's at the same width;
* on random codes at w = 600 and 900 no Viterbi walk leaves the live
  band, on either plane;
* the forward-only kernel's group vote (csrc/forward.cu at W = 768 and
  1024): on reads whose first delete state emits an N with NaN, the
  two-term sum's check first fails, chunk by chunk, in the top live
  warp's cells alone (512-599 at w = 600, whose top warp, all dead
  lanes, passes; 896-899, one lane's, at w = 900), and a model of the
  kernel's switch whose check spans the whole band (the group's vote)
  gives the plain version's bits;
* a switch at the group's band maximum: in 1024 lanes, reads with runs
  of N under N emissions of 1e-37 switch mid-read and the model of the
  kernel's switch ends each with the plain version's finite bits;
* the walker's ring (csrc/walk.cuh): the numpy model of
  tests/test_torch_widest_viterbi.py at 32 diagonals a chunk, the full
  plane's at W = 768 and 1024, on full planes spanning many chunks,
  gives the plain walker's ops and end cells;
* the Viterbi plain version's lookups many diagonals at a time give the
  bits of one at a time, on both planes;
* the width guard without a card: every Viterbi entry point takes 513,
  600, 768, 900 and 1024 past the guard, and refuses 1025 naming C11;
* the Viterbi path at w = 1100 on the CPU, laid into the MEA path's
  W = 1536 layout since ROADMAP C11's seventh step (unpadded before):
  both planes, the walks and the forward loglik the unpadded band's bit
  for bit, and ``MappingEngine(band_width=1100, decode="viterbi")``'s
  records those of the unpadded layout.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nanopore_tpu_torch.io.seqio import read_fasta_dict
from nanopore_tpu_torch.mapping.engine import MappingEngine
from nanopore_tpu_torch.mapping.presets import MAPPER_REGISTRY
from nanopore_tpu_torch.ops import realign as port_realign
from nanopore_tpu_torch.ops import viterbi as V
from nanopore_tpu_torch.ops.forward import forward_loglik_plain, two_term_sum
from nanopore_tpu_torch.ops.pack import check_band_width, padded_width
from nanopore_tpu_torch.ops.pairhmm import kernel_tables
from nanopore_tpu_torch.ops.traceback import viterbi_walk_plain
from test_torch_chain_realign import sam_records, write_small_inputs
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
from test_torch_widest_viterbi import _ring_walk
from test_torch_widths import _packed, _params, width_pairs

W1024 = (600, 768, 900, 1024)  # dead warp in 768; none; one lane; none
PADDED = (600, 900)
# the N's offset above w in each pair vote read: at w = 900 the N enters
# the top warp's one live lane in the last diagonals of a chunk of 64,
# before the NaN spreads into the warp below (chip_smoke.py's
# PAIR_VOTE_AT)
VOTE_AT = {600: (100, 150, 200, 240, 280), 900: (122, 154, 186, 218, 250)}
# runs of N long enough for a band of 1024, as chip_smoke.py's
# N_RUNS_W1024
N_RUNS_W1024 = ((2400, 600, 1000), (2240, 400, 1040), (2000, 480, 920),
                (2200, 600, 1080), (2080, 0, 0))
# walk.cuh's chunk<W, T>() for the full plane's rows of more than 1024
# bytes (W = 768 and 1024)
FULL_CHUNK = 32


@pytest.fixture(scope="module")
def pairs():
    return width_pairs()[:3]


@pytest.fixture(scope="module")
def layouts(pairs):
    return {w: _case(pairs, w) for w in W1024}


@pytest.fixture(scope="module")
def full_cases():
    jp, pp = both_params("i")
    pairs = full_pairs() + width_pairs()[:2]
    return pairs, jp, pp, {w: _case(pairs, w) for w in W1024}


@pytest.mark.parametrize("w", W1024)
def test_viterbi_matches_viterbi_decode_batch(pairs, layouts, w):
    """Score <= 1e-5 relative, fstate and cigars identical."""
    viterbi_matches_jax(pairs, layouts, w)


@pytest.mark.parametrize("w", W1024)
def test_forward_loglik_matches_jax(layouts, w):
    """Loglik <= 1e-5 relative of ``forward_loglik``, under the default
    model (the kernel's two-term gap sum) and model (i) (its 5-way
    sum)."""
    forward_matches_jax(layouts, w)


@pytest.mark.parametrize("w", W1024)
def test_full_plane_matches_the_xla_scan(full_cases, w):
    """tests/test_torch_viterbi_full.py's bar at w: on the scan's own
    tables the scan's scores bit for bit, its fstates and backpointers;
    on the port's tables score 1e-5 relative, fstate, the plane on every
    lattice cell and the cigars identical."""
    full_plane_matches_jax(full_cases, w)


@pytest.mark.parametrize("w", PADDED)
def test_padded_layout_gives_the_unpadded_bits(full_cases, w):
    """Both planes: the live lanes of the plane and every other output
    bit for bit the unpadded band's (at 600 the top warp of 768 lanes
    holds dead lanes alone)."""
    padded_gives_unpadded(full_cases, w)


def test_viterbi_engine_matches_the_jax_engine_at_900(tmp_path):
    """``MappingEngine(band_width=900, decode="viterbi")`` on the CPU:
    every record equal to the JAX engine's at the same width (its XLA
    scan), field by field."""
    engine_matches_jax(tmp_path, 900)


@pytest.mark.parametrize("w", PADDED)
def test_no_viterbi_walk_leaves_the_live_band_on_random_codes(w):
    """Unrelated random sequences under random guides at w: the paths
    press on the band's edges, and no walk on either plane leaves lanes
    0..w-1 of its padded layout."""
    no_walk_leaves_the_live_band(w)


# ---- the forward-only kernel's group vote (W = 768 and 1024) ------------- #

@pytest.mark.parametrize("w", PADDED)
def test_the_group_vote_fails_the_top_live_warp_alone_and_keeps_the_plain_bits(
        w):
    """In each N read the NaN state starts in the top live warp's cells
    (512..599 of 768 at w = 600, below a warp of dead lanes; 896..899 of
    1024 at w = 900, one lane's) and spreads down about half a cell a
    diagonal, so the first chunk of 64 diagonals with a non-finite gap
    state in the two-term recursion has one in that warp's cells and
    none in any other warp's: a vote per warp would keep the others'
    two-term chunk while that warp reran it.  The model of the kernel's
    switch, whose check spans the whole band (the group's vote), sends
    each N read to the 5-way sum from that chunk's start and gives the
    plain version's bits (NaN once the NaN reaches the end cell); the
    N-free read keeps the two-term sum and its finite loglik."""
    pairs, pp = _pair_vote_case(w, VOTE_AT[w])
    _, xyc, m, n = _packed(pairs, w, padded_width(w))
    lo = (w - 1) // 128 * 128  # the top live warp's first cell
    hi = lo + 128
    assert two_term_sum(kernel_tables(pp))
    assert (hi < xyc.shape[2]) == (w == 600) and w - lo == {600: 88,
                                                            900: 4}[w]
    want = forward_loglik_plain(xyc, m, n, pp)
    ll, _, _, switched = _model_run(xyc, m, n, pp, "switch")
    assert torch.equal(_bits(ll), _bits(want))
    assert torch.isnan(want[:-1]).all() and torch.isfinite(want[-1])
    _, states, _, _ = _model_run(xyc, m, n, pp, "two")
    bad = ~torch.isfinite(torch.stack(states)[:, :, 1:])  # (k, B, 4, W)
    for b in range(len(pairs) - 1):
        chunk = next(c for c in range(0, len(states), 64)
                     if bad[c:c + 64, b].any())
        assert not bad[chunk:chunk + 64, b, :, :lo].any()
        assert not bad[chunk:chunk + 64, b, :, hi:].any()
        assert bad[chunk:chunk + 64, b, :, lo:w].any()
        assert switched[b] == chunk + 1
    assert switched[-1] == -1 and not bad[:, -1].any()


def test_a_switch_at_the_groups_band_maximum_ends_finite_with_the_plain_bits():
    """In 1024 lanes the band maximum of four N-run reads falls below
    FLT_MIN mid-read (a check every warp fails, the maximum being the
    group's); the model of the kernel's switch sends each from that
    chunk's start to the 5-way sum and ends with the plain version's
    bits, every loglik finite."""
    pairs, pp = _finite_switch_case(N_RUNS_W1024)
    _, xyc, m, n = _packed(pairs, 1024, 1024)
    assert two_term_sum(kernel_tables(pp))
    want = forward_loglik_plain(xyc, m, n, pp)
    ll, _, _, switched = _model_run(xyc, m, n, pp, "switch")
    assert torch.equal(_bits(ll), _bits(want))
    assert torch.isfinite(want).all()
    kend = (m + n).long()
    mid = ((switched > 1) & (switched < kend)).tolist()
    assert mid == [True, True, True, True, False]
    assert ((switched[mid] - 1) % 64 == 0).all()


# ---- the walker's ring (csrc/walk.cuh) ----------------------------------- #

@pytest.mark.parametrize("plane", ["viterbi", "random"])
@pytest.mark.parametrize("w", PADDED)
def test_the_walkers_ring_of_32_diagonals_gives_the_plain_walk(plane, w):
    """Full planes at W = 768 (w = 600) and 1024 (w = 900): the
    Viterbi's under model (i), whose walks reach the origin, and a
    random one (every field a random state, random end states, one
    read's m past k_pad), whose walks end short or leave the band.  Each
    spans 20 or more chunks of 32, and the ring model gives the plain
    walker's ops and end cells bit for bit."""
    rng = np.random.default_rng(w)
    pairs = full_pairs() + width_pairs()[:2]
    _, xyc, m, n = _packed(pairs, w, padded_width(w))
    B, k_pad, W = xyc.shape
    assert W * 2 > 1024 and k_pad >= 20 * FULL_CHUNK
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


# ---- the plain version's lookups ----------------------------------------- #

@pytest.mark.parametrize("chunk", [7, 64])
def test_plain_viterbi_lookups_in_batches_give_the_one_at_a_time_bits(
        monkeypatch, chunk):
    """The Viterbi plain version takes its emissions and band shifts'
    gather indices ``LOOKUP_DIAGS`` diagonals at a time on one intra-op
    thread and one at a time on several: both planes give the same
    score, fstate and plane bits either way, at a chunk that divides
    nothing (7) and at the card's 64, at live widths 48 (in 64 lanes),
    200 (in 256) and 600 (in 768), on reads of 70 to 300 bases (k_pad
    640: ten chunks of 64)."""
    pairs = full_pairs()[4:]
    tables = {False: V.viterbi_tables(_params()),
              True: V.viterbi_full_tables(both_params("i")[1])}
    batches = [_packed(pairs, w, padded_width(w))[1:] for w in (48, 200, 600)]

    def outputs():
        return [V.plain_forward(xyc, m, n, tables[full], full)
                for xyc, m, n in batches for full in (False, True)]

    before = torch.get_num_threads()
    try:
        torch.set_num_threads(2)  # one diagonal at a time
        want = outputs()
        torch.set_num_threads(1)
        monkeypatch.setattr(port_realign, "LOOKUP_DIAGS", chunk)
        got = outputs()
    finally:
        torch.set_num_threads(before)
    for g, w in zip(got, want):
        assert g["bp"].dtype == w["bp"].dtype
        for key in w:
            assert torch.equal(g[key], w[key]), key


# ---- the width guard (ROADMAP C11), without a card ----------------------- #

@pytest.mark.parametrize("w", [513, 600, 768, 900, 1024])
def test_viterbi_entry_points_take_513_to_1024_past_the_guard(w, monkeypatch):
    """``MappingEngine(decode="viterbi")``, ``PreparedViterbi`` and
    ``PreparedForward`` take w past the guard on the card, laid into 768
    or 1024 lanes."""
    assert padded_width(w) == (768 if w <= 768 else 1024)
    viterbi_entry_points_take(w, monkeypatch)


def test_the_viterbi_path_refuses_1025_naming_c11(monkeypatch):
    """Above 1024 every Viterbi entry point refuses the band on the card
    before any work (no pack), naming C11, and the message gives the
    Viterbi path's 2 to 1024 beside the MEA path's 2 to 2048 (which
    takes 1025 since ROADMAP C11's seventh step); the CPU serves it, in
    the W = 1536 layout since that step (unpadded before: its records
    are unchanged, test_the_viterbi_records_at_1100_are_unchanged_by_the_padded_layout)."""
    monkeypatch.setattr("nanopore_tpu_torch.ops.dispatch.pack_stream_pairs",
                        _past_the_guard)
    for name, call in _viterbi_entry_points(1025).items():
        with pytest.raises(ValueError, match="C11") as err:
            call()
        assert ("the MEA path's kernels take widths 2 to 2048 and the "
                "Viterbi path's 2 to 1024") in str(err.value), name
    check_band_width(1025, "cpu")
    check_band_width(1025, "cuda", "mea")
    assert padded_width(1025) == 1536


# ---- the CPU's Viterbi path at 1025 to 2048 (ROADMAP C11, seventh step) --- #

def test_the_viterbi_records_at_1100_are_unchanged_by_the_padded_layout(
        tmp_path, monkeypatch):
    """A band of 1025 to 1536 lies in the W = 1536 layout on either device
    since the MEA path's kernels serve it; the Viterbi path, whose
    kernels stop at 1024, then runs its plain versions in that layout on
    the CPU.  At w = 1100 both planes' live lanes, the scores, fstates,
    walks and end cells, and the forward loglik (under both gap sums'
    models) are the unpadded band's bit for bit, and
    ``MappingEngine(band_width=1100, decode="viterbi")`` on the CPU
    writes the records it wrote when such a band was unpadded."""
    w = 1100
    assert padded_width(w) == 1536
    jp, pp = both_params("i")
    pairs = full_pairs() + width_pairs()[:2]
    padded_gives_unpadded((pairs, jp, pp, {w: _case(pairs, w)}), w)

    fa, fq = write_small_inputs(tmp_path, 5, n_reads=4)
    cfg = dataclasses.replace(MAPPER_REGISTRY["Viterbi"].config,
                              band_width=w)
    assert cfg.decode == "viterbi"
    records = {}
    for layout in ("padded", "unpadded"):
        if layout == "unpadded":  # the layout before the seventh step
            monkeypatch.setattr(
                "nanopore_tpu_torch.ops.dispatch.padded_width",
                lambda band: band if band > 1024 else padded_width(band))
        sam = str(tmp_path / (layout + ".sam"))
        MappingEngine(read_fasta_dict(fa), cfg, device="cpu").map_fastq(
            fq, sam)
        records[layout] = sam_records(sam)
    assert len({r[0] for r in records["padded"]}) == 4
    assert records["padded"] == records["unpadded"]
