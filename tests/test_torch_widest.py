"""Band widths 257 to 512 in the port's W = 384 and W = 512 layouts (the
MEA path), on the CPU, against the JAX package's XLA-scan route at the
same width.

A band of live width 256 < w <= 384 lies in the first w lanes of
W = 384 lanes, and 384 < w <= 512 in W = 512 (``ops.pack.padded_width``),
its dead lanes all sentinel, on either device.  On the card the MEA
path's kernels (pack, realign in every mode with the band held by a
group of three or four warps, the MEA walker) serve these widths;
tests/test_torch_widest_viterbi.py holds the Viterbi path there (since
ROADMAP C11's fourth step).  At w = 300 (dead
lanes in the top warp of W = 384), 384 (none), 450 (in W = 512) and 512
(none), on the first three of ``width_pairs()``' reads (a pure match, a
long deletion, a long insertion; the five take the file past its time):

* the packed codes: lanes < w those of the JAX package's packs at w,
  lanes >= w the sentinel with the row's bits 6-7; and a numpy model of
  csrc/pack.cu's chunks at W = 384 and 512 (bands wider than its chunk
  of 256 diagonals) byte for byte the plain pack;
* against the JAX package at w: realign loglik <= 1e-5 relative with
  identical MEA cigars (``realign_fused``); the gamma band <= 5e-5
  (``forward_backward``); the retire rows and flush <= 5e-5 (the XLA
  retire scan); EM sums within 3e-5 of each table's largest entry
  (``em_expectations``);
* at w = 300 and 450, every realign mode in the padded layout gives,
  bit for bit in the live lanes, what the plain versions give on the
  unpadded band;
* at w = 300: ``em_train`` (models within 3e-5 relative) and
  ``realign_sam_file`` (records equal) against the JAX package;
* the kernels' own rules: the EM mode's lane sums at W = 384 (96 lanes,
  three warps: warp 2 onto warp 0, then warp 1, then one warp's
  butterfly) and W = 512 (128 lanes: the butterfly's two steps across
  the warps, then one warp's); the decode's workspace plan puts the
  card's mapping batch at W = 512 into as many launches (8) as the
  8 GiB cap takes its reads' slots, each read within
  ``max_workspace_k``; the decode's backward segment, 4 diagonals
  above W = 256 (8 below): a model of its checkpoints, recomputed
  segment by segment, gives the continuous backward's states bit for
  bit at either segment;
* the width guard without a card: every entry point of the MEA path
  takes 257, 300, 384 and 512 past the guard (the Viterbi path's are
  tests/test_torch_widest_viterbi.py's), and the Viterbi path's kernel
  wrappers take the W = 384, 512, 768 and 1024 layouts and refuse 257
  and 1025 lanes; the MEA path refuses 2049 and the Viterbi path 1025,
  naming C11; and the CPU serves 600 (the EM sums against the JAX package's, in the 768 lanes
  of the card's layout).
"""

import numpy as np
import pytest
import torch

from nanopore_tpu.align import em as jax_em
from nanopore_tpu.align import realign as jax_realign
from nanopore_tpu.ops import posteriors as jax_post
from nanopore_tpu.ops.mea import mea_traceback_fwd, realign_fused
from nanopore_tpu.ops.pairhmm import em_expectations, forward_backward
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu.ops.pairhmm_pallas_realign import pack_pallas_pairs
from nanopore_tpu_torch.align import em as port_em
from nanopore_tpu_torch.align import realign as port_realign_stage
from nanopore_tpu_torch.ops import dispatch
from nanopore_tpu_torch.ops import realign as port_realign
from nanopore_tpu_torch.ops.pack import (
    SENT,
    check_band_width,
    padded_width,
)
from nanopore_tpu_torch.ops.pairhmm import kernel_tables
from nanopore_tpu_torch.ops.realign import (
    DIR_NONE,
    em_lanes,
    realign_decode,
    realign_gamma,
    untile,
)
from nanopore_tpu_torch.ops.traceback import mea_walk, rle_ops_batch
from test_torch_chain_realign import (  # noqa: F401
    mapped,
    sam_records,
)
from test_torch_em import _global_pairs
from test_torch_pack import _plain, _scan_lookup_pack
from test_torch_wide import (
    _mea_entry_points,
    _past_the_guard,
    _PastTheGuard,
    _viterbi_entry_points,
)
from test_torch_wider_viterbi import one_thread  # noqa: F401
from test_torch_widths import (
    EXP_KW,
    THRESHOLD,
    _expectations_f32,
    _jparams,
    _modes,
    _packed,
    _params,
    _prepared,
    _valid_cells,
    width_pairs,
)

WIDEST = (300, 384, 450, 512)  # dead lanes in W = 384; none; in 512; none
PADDED = (300, 450)


@pytest.fixture(scope="module")
def pairs():
    return width_pairs()[:3]


@pytest.fixture(scope="module")
def layouts(pairs):
    """Per width: the padded batch, the JAX package's banded batch over
    the same diagonals and its ``forward_backward`` (the gamma band's
    and the retire scan's reference)."""
    out = {}
    for w in WIDEST:
        pad = _packed(pairs, w, padded_width(w))
        batch = prepare_banded_batch(pairs, band_width=w,
                                     k_max=pad[0]["k_pad"])
        out[w] = {"pad": pad, "jax": batch,
                  "fb": forward_backward(batch, _jparams())}
    return out


# ---- the layout ---------------------------------------------------------- #

@pytest.mark.parametrize("w", WIDEST)
def test_packed_codes_are_jax_codes_then_sentinel_lanes(pairs, layouts, w):
    prep, xyc, _, _ = layouts[w]["pad"]
    W = 384 if w <= 384 else 512
    assert padded_width(w) == W and prep["W"] == W
    assert prep["band_width"] == w
    codes = xyc.numpy().view(np.uint8)
    B, k_pad = len(pairs), prep["k_pad"]
    assert codes.shape == (B, k_pad, W)
    host = untile(pack_pallas_pairs(pairs, _jparams(), band_width=w,
                                    k_max=k_pad)["xyc"], B).view(np.uint8)
    np.testing.assert_array_equal(codes[:, :, :w], host)
    np.testing.assert_array_equal(
        prep["offsets"], np.asarray(layouts[w]["jax"].offsets))
    dead = codes[:, :, w:]
    assert dead.shape[2] == W - w
    assert (dead & 0x3F == SENT).all()
    assert (dead & 0xC0 == codes[:, :, :1] & 0xC0).all()
    disp = dispatch.prepared_from_pairs({"device": "cpu"}, pairs, _params(),
                                        band_width=w, k_max=k_pad,
                                        exact_k=True)
    assert disp.batch.band_width == w
    assert torch.equal(disp.xyc, xyc)


@pytest.mark.parametrize("W", [384, 512])
def test_pack_kernel_model_wider_than_its_chunk_matches_the_plain_pack(W):
    """csrc/pack.cu at W = 384 and 512, bands wider than its chunk of 256
    diagonals, so a buffer's head of W symbols reaches back past the
    chunk before: the numpy model of its buffers (each lookup inside
    what its chunk and its head wrote) byte for byte the plain pack on
    random bytes over four chunks, reads shorter than one, across chunks
    and past k_pad."""
    rng = np.random.default_rng(W)
    B, k_pad = 6, 896
    stream = rng.integers(0, 256, (B, k_pad)).astype(np.uint8)
    stream[1] &= 0xBF  # never shifts: Y alone
    stream[2] |= 0x40  # always shifts: X alone
    initx = rng.integers(0, 256, (B, W)).astype(np.uint8)
    m = np.array([40, 300, k_pad + 50, 0, 7, k_pad // 2], np.int32)
    n = np.array([90, k_pad + 9, 60, 5, 0, k_pad // 2], np.int32)
    np.testing.assert_array_equal(_scan_lookup_pack(stream, initx, m, n),
                                  _plain(stream, initx, m, n))


@pytest.mark.parametrize("w", PADDED)
def test_padded_layout_gives_the_unpadded_bits(pairs, layouts, w):
    """Each output's live lanes are the unpadded band's, bit for bit;
    the dead lanes hold DIR_NONE in the direction codes and 0 in the
    gamma band and the flush.  (The plain EM mode lays the unpadded band
    into the kernel's layout too: ``ops.realign.em_width``.)"""
    bare = _packed(pairs, w)
    assert torch.equal(layouts[w]["pad"][1][:, :, :w], bare[1])
    got = _modes(layouts[w]["pad"], w)
    want = _modes(bare)
    for mode in got:
        for key, a in got[mode].items():
            if key in ("dirs", "gamma", "bp", "flush"):
                a = a[:, :, :w]
            assert torch.equal(a, want[mode][key]), (mode, key)
    assert (got["decode"]["dirs"][:, :, w:] == DIR_NONE).all()
    assert (got["decode"]["gamma"][:, :, w:] == 0).all()
    assert (got["gamma"]["gamma"][:, :, w:] == 0).all()
    assert (got["exp"]["flush"][:, :, w:] == 0).all()


# ---- against the JAX package's XLA scan at the same width ---------------- #

@pytest.mark.parametrize("w", WIDEST)
def test_realign_matches_jax_realign_fused(pairs, layouts, w):
    batch = layouts[w]["jax"]
    want = realign_fused(batch, _jparams(), segment_size=8)
    prep, xyc, m, n = layouts[w]["pad"]
    got = realign_decode(xyc, m, n, _params(), band_width=w)
    np.testing.assert_allclose(got["loglik"].numpy(),
                               np.asarray(want["loglik"]), rtol=1e-5)
    cigars = rle_ops_batch(mea_walk(got["dirs"], xyc, m, n).numpy())
    offsets = np.asarray(batch.offsets)
    want_dirs = np.asarray(want["dirs"])
    for b, (x, y, _) in enumerate(pairs):
        assert cigars[b] == mea_traceback_fwd(want_dirs[b], offsets[b],
                                              len(y), len(x))


@pytest.mark.parametrize("w", WIDEST)
def test_gamma_band_matches_forward_backward(pairs, layouts, w):
    batch, fb = layouts[w]["jax"], layouts[w]["fb"]
    want = np.asarray(fb["gamma_match"])
    prep, xyc, m, n = layouts[w]["pad"]
    got = realign_gamma(xyc, m, n, _params(), band_width=w)
    np.testing.assert_allclose(got["loglik"].numpy(),
                               np.asarray(fb["loglik"]), rtol=1e-5)
    band = got["gamma"].numpy()[:, :, :w]
    offsets = np.asarray(batch.offsets)
    K1 = want.shape[1]
    for b, (x, y, _) in enumerate(pairs):
        valid = _valid_cells(offsets[b], K1, w, len(y), len(x))
        assert np.abs(band[b][:K1][valid] - want[b][valid]).max() <= 5e-5


@pytest.mark.parametrize("w", WIDEST)
def test_retire_rows_and_flush_match_the_xla_retire_scan(pairs, layouts, w):
    batch, fb = layouts[w]["jax"], layouts[w]["fb"]
    want = jax_post.posterior_expectations_batch(
        fb["gamma_match"], batch.yc, np.asarray(batch.offsets),
        np.asarray(batch.n), threshold=THRESHOLD)
    prepared = _prepared(pairs, w, EXP_KW,
                         prepared_cls=dispatch.PreparedPosteriors)
    assert prepared.xyc.shape[2] == padded_width(w)
    out = prepared.run()  # ret and the flush sliced to the live width
    assert out["flush"].shape[2] == w
    lite = prepared.batch
    got = _expectations_f32(out["ret"], out["flush"], lite.offsets, lite.n,
                            w)
    for g, e in zip(got, want):
        assert g.shape == e.shape
        assert np.abs(g - e).max() <= 5e-5


def _em_against_jax(pairs, w):
    prepared = _prepared(pairs, w, {}, prepared_cls=dispatch.PreparedEm)
    assert prepared.xyc.shape[2] == padded_width(w)
    got = prepared.run(_params())
    batch = prepare_banded_batch(pairs, band_width=w,
                                 k_max=prepared.xyc.shape[1])
    want = em_expectations(batch, _jparams(), segment_size=8)
    np.testing.assert_allclose(got["loglik"].numpy(),
                               np.asarray(want["loglik"]), rtol=1e-5)
    for key in ("trans", "emis"):
        e = np.asarray(want[key]).reshape(len(pairs), -1)
        g = got[key].numpy().reshape(len(pairs), -1)
        assert (np.abs(g - e).max(axis=1) / np.abs(e).max(axis=1)).max() \
            <= 3e-5, key


@pytest.mark.parametrize("w", WIDEST)
def test_em_sums_match_em_expectations(pairs, w):
    _em_against_jax(pairs, w)


def test_em_train_matches_jax_em_train_at_300():
    pairs = _global_pairs(count=4)
    opts = dict(trials=1, iterations=2, band_width=300, seed=3, window_pad=32)
    got = port_em.em_train(pairs, port_em.EmOptions(batch_size=8, **opts),
                           device="cpu")
    want = jax_em.em_train(pairs, jax_em.EmOptions(use_mesh=False, **opts))
    np.testing.assert_allclose(got.running_likelihoods[0],
                               want.running_likelihoods[0], rtol=1e-5)
    np.testing.assert_allclose(got.model.transitions, want.model.transitions,
                               rtol=3e-5)
    np.testing.assert_allclose(got.model.emissions, want.model.emissions,
                               rtol=3e-5)


def test_realign_sam_file_matches_jax_at_300(mapped):  # noqa: F811
    d = mapped["dir"]
    jax_realign.realign_sam_file(
        mapped["sam"], str(d / "j_w300.sam"), mapped["fq"], mapped["fa"],
        band_width=300)
    port_realign_stage.realign_sam_file(
        mapped["sam"], str(d / "p_w300.sam"), mapped["fq"], mapped["fa"],
        band_width=300, device="cpu")
    got = sam_records(str(d / "p_w300.sam"))
    assert len(got) == 8
    assert got == sam_records(str(d / "j_w300.sam"))


# ---- the kernels' own rules at W = 384 and 512 --------------------------- #

@pytest.mark.parametrize("W", [384, 512])
def test_lane_total_folds_the_warps_then_one_warps_butterfly(W):
    """The EM sums lie in W / 4 lanes of 4 cells (the kernel's G = W / 128
    warps of 32).  At W = 384 warp 2 adds onto warp 0, then warp 1, lane
    for lane; at W = 512 warps 2 and 3 onto warps 0 and 1, then warp 1
    onto warp 0 (the xor butterfly's steps across warps); then one
    warp's butterfly (16, 8, 4, 2, 1).  The result is that order bit for
    bit, and not another."""
    G = W // 128
    assert em_lanes(W) == 32 * G
    rng = np.random.default_rng(W)
    acc = (rng.standard_normal((3, 57, 32 * G))
           * 10.0 ** rng.uniform(-6, 6, (3, 57, 32 * G))).astype(np.float32)
    got = port_realign._lane_total(torch.from_numpy(acc))
    w = [torch.from_numpy(acc[..., 32 * i:32 * (i + 1)]) for i in range(G)]
    warp = (w[0] + w[2]) + w[1] if G == 3 else (w[0] + w[2]) + (w[1] + w[3])
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        warp = warp + warp[..., lanes ^ off]
    assert torch.equal(got, warp[..., 0])
    # warps added in turn (0, 1, 2, ...) sum otherwise
    seq = w[0]
    for i in range(1, G):
        seq = seq + w[i]
    for off in (16, 8, 4, 2, 1):
        seq = seq + seq[..., lanes ^ off]
    assert not torch.equal(got, seq[..., 0])
    if W == 512:  # the 128-lane xor butterfly is the fold
        full = torch.from_numpy(acc)
        lanes128 = torch.arange(128)
        for off in (64, 32, 16, 8, 4, 2, 1):
            full = full + full[..., lanes128 ^ off]
        assert torch.equal(got, full[..., 0])


def test_em_width_lays_257_to_384_into_384():
    assert [port_realign.em_width(w) for w in (200, 256, 257, 300, 384,
                                               385, 450, 512, 600)] == [
        256, 256, 384, 384, 384, 512, 512, 512, 768]


def test_decode_plan_fits_the_mapping_batch_at_512_in_its_launches():
    """chip_smoke.py's mapping batch (512 reads, m + n of ~9,750 and up
    to its k_pad of 10,240) at W = 512: a read's decode slot (the
    segment of 4 diagonals: ~12.7 KB a diagonal, ~136 MB a read) fits
    the 8 GiB cap, and the batch takes as many launches of whole reads
    as the cap allows reads of the longest slot, each within the cap."""
    rng = np.random.default_rng(9)
    m = rng.integers(4700, 5000, 512)
    n = rng.integers(9_500, 10_240, 512) - m
    n[0] = 10_240 - m[0]
    cap = port_realign.WORKSPACE_BYTES
    offsets, launches = port_realign.workspace_plan(
        m, n, 512, cap, port_realign.DECODE)
    per_read = port_realign.read_workspace_bytes(10_240, 512,
                                                 port_realign.DECODE)
    assert 130e6 < per_read < 140e6
    assert port_realign.segment(512) == 4 and port_realign.segment(256) == 8
    # one read alone would fit far longer windows; the batch splits
    assert port_realign.max_workspace_k(512, port_realign.DECODE) > 10_240
    assert len(launches) == 8
    assert launches[0][0] == 0 and launches[-1][1] == 512
    for (r0, r1), (s0, _) in zip(launches, launches[1:]):
        assert r1 == s0
        assert offsets[r1 + 1] - offsets[r0] > cap  # the next read would not fit
    for r0, r1 in launches:
        assert offsets[r1] - offsets[r0] <= cap
    # the slot: states, scales and one 6 x W checkpoint per 4 diagonals
    kq = 10_240
    assert per_read == (kq * 5 * 512 * 4 + 2 * ((kq + 4) // 4) * 16
                        + (kq // 4 + 1) * 6 * 512 * 4)


def _backward(codes, m, n, tab, W, ckpt=None):
    """The decode modes' backward recursion over diagonals kq..0 in the
    plain version's arithmetic, one read; returns each diagonal's
    rescaled states ``nw`` and its scale ``safe``.  With ``ckpt`` =
    (k_top, k_low, b1, b2m, safe above) it runs diagonals k_top..k_low
    from a checkpoint (the states carried into k_top, the rescale inverse
    of the diagonal above taken as 1 / safe there) and the emissions of
    the two diagonals above, as the kernel's producers recompute a
    segment."""
    tf = tab[:25].reshape(5, 5)
    emf, egf = tab[25:61], tab[61:91]
    kend = m + n
    kq = kend + (kend & 1)
    base = torch.arange(W) + 1

    def emis(k):
        if k < 1 or k > kq:
            return torch.zeros(5, W), 0
        c = codes[k - 1]
        x, y = (c >> 3) & 7, c & 7
        E = torch.stack([emf[x * 6 + y], egf[6 + x], egf[12 + y],
                         egf[18 + x], egf[24 + y]])
        return E, int(c[0] >> 6) & 1

    def shift(a, s, fill):
        padded = torch.cat([torch.full((1,), fill), a, torch.full((1,), fill)])
        return padded[base + s]

    if ckpt is None:
        top, low, b1, b2m, binv = kq, 0, torch.zeros(5, W), torch.zeros(W), 1.0
    else:
        top, low, b1, b2m, safe_above = ckpt
        binv = np.float32(1.0) / np.float32(safe_above)
    E1, d1n1 = emis(top + 1)
    E2, d1n2 = emis(top + 2)
    em2 = E2[0]
    live = torch.ones(W, dtype=torch.bool)
    end = torch.zeros(5, W)
    end[:, 0] = 1.0
    out = {}
    for k in range(top, low - 1, -1):
        d2n2 = d1n1 + d1n2 - 1
        P = [b2m * em2, b1[1] * E1[1], b1[2] * E1[2], b1[3] * E1[3],
             b1[4] * E1[4]]
        S = [-d2n2, 1 - d1n1, -d1n1, 1 - d1n1, -d1n1]
        dest = torch.stack([shift(P[i], S[i], 0.0) for i in range(5)])
        dest[0] = dest[0] * torch.tensor(binv, dtype=torch.float32)
        new = dest[0][None] * tf[:, 0][:, None]
        for t in range(1, 5):
            new = new + tf[:, t][:, None] * dest[t][None]
        new = torch.where(torch.tensor(k == kend), end, new)
        new = torch.where(live, new, 0.0)
        safe = torch.tensor(1.0)
        if k % 2 == 1 or k == 0:
            scale = new.amax()
            safe = torch.where(scale > 0, scale, torch.ones(()))
            new = new * (1.0 / safe)
        out[k] = (new, float(safe))
        b2m, b1, binv = b1[0], new, float(1.0 / safe)
        em2 = E1[0]
        E1, d1k = emis(k)
        d1n2, d1n1 = d1n1, d1k
    return out


@pytest.mark.parametrize("S", [4, 8])
def test_recomputed_backward_segments_are_the_stored_states(pairs, S):
    """The decode modes' backward segments (csrc/realign.cu
    ``mea_segment``: 4 diagonals above W = 256, 8 below): from each
    segment's checkpoint (the states carried into its top diagonal and
    the scale of the diagonal above), the recomputed states are the
    continuous backward's bit for bit at every diagonal, at either
    segment, so the MEA pass reads the same floats whatever the
    segment and the decode's outputs do not depend on it (W = 384, live
    width 300)."""
    prep, xyc, m, n = _packed(pairs[:2], 300, 384)
    tab = kernel_tables(_params())
    for r in range(2):
        codes = xyc[r].to(torch.int32) & 0xFF
        mr, nr = int(m[r]), int(n[r])
        whole = _backward(codes, mr, nr, tab, 384)
        kq = (mr + nr) + ((mr + nr) & 1)
        carried = {}  # the states carried into each diagonal
        prev = None
        for k in range(kq, -1, -1):
            carried[k] = prev
            prev = whole[k][0]
        for j in range(kq // S + 1):
            hi = min(kq, j * S + S - 1)
            b1 = carried[hi] if hi < kq else torch.zeros(5, 384)
            b2m = (carried[hi + 1][0] if hi + 1 < kq else torch.zeros(384)) \
                if hi < kq else torch.zeros(384)
            safe_above = whole[hi + 1][1] if hi < kq else 1.0
            seg = _backward(codes, mr, nr, tab, 384,
                            (hi, j * S, b1, b2m, safe_above))
            for k in range(hi, j * S - 1, -1):
                assert torch.equal(seg[k][0], whole[k][0]), (r, S, k)
                assert seg[k][1] == whole[k][1]


# ---- the width guard (ROADMAP C10, C11), without a card ------------------ #

@pytest.mark.parametrize("w", [257, 300, 384, 512])
def test_mea_entry_points_take_257_to_512_past_the_guard(
        mapped, tmp_path, monkeypatch, w):  # noqa: F811
    monkeypatch.setattr(port_realign_stage, "chain_sam_file",
                        _past_the_guard)
    check_band_width(w, "cuda")
    for name, call in _mea_entry_points(mapped, tmp_path, w).items():
        with pytest.raises((ValueError, _PastTheGuard)) as err:
            call()
        assert "C10" not in str(err.value), name
        assert "C11" not in str(err.value), name
        if err.type is ValueError:
            assert "unsupported device" in str(err.value), name


def test_viterbi_entry_points_refuse_257_naming_c11():
    """The name keeps the case this test once held: the Viterbi path's
    entry points refused a band of 257 on the card, naming C11.  Since
    ROADMAP C11's fourth step they serve 257 to 512, and since its sixth
    513 to 1024 (tests/test_torch_widest_viterbi.py and
    tests/test_torch_w1024_viterbi.py hold their guard), so this holds
    the level below them: the Viterbi path's kernel wrappers (K4 at each
    step, K5 on both planes, K6 at both sums) take a batch in the
    W = 384, 512, 768 and 1024 layouts, and refuse one of 257 or 1025
    lanes, which no layout has (a band of live width 257 lies in 384
    lanes, one of 1025 on the CPU alone)."""
    from nanopore_tpu_torch.ops import forward as port_forward
    from nanopore_tpu_torch.ops import viterbi as port_viterbi
    from nanopore_tpu_torch.ops.traceback import viterbi_walk

    def wrappers(W):
        xyc = torch.empty((0, 4, W), dtype=torch.int8, device="meta")
        m = torch.empty(0, dtype=torch.int32, device="meta")
        tab = torch.empty(0, device="meta")
        calls = [lambda two=two: port_forward._launch(xyc, m, m, tab, two)
                 for two in (True, False)]
        for step, dtype in ((port_viterbi.SHORT, torch.int8),
                            (port_viterbi.FIVE_WAY, torch.int8),
                            (port_viterbi.FULL, torch.int16)):
            bp = torch.empty((0, 5, W), dtype=dtype, device="meta")
            calls += [lambda step=step: port_viterbi._launch(xyc, m, m, tab,
                                                            step),
                      lambda bp=bp: viterbi_walk(bp, xyc, m, m, m)]
        return calls

    for W in (384, 512, 768, 1024):
        for call in wrappers(W):
            call()
    for W in (257, 1025):
        for call in wrappers(W):
            with pytest.raises(ValueError, match="serves? W in"):
                call()


def test_every_path_refuses_513_naming_c11(mapped, tmp_path,
                                           monkeypatch):  # noqa: F811
    """The name keeps the case this test once held, every path's refusal
    of 513: since ROADMAP C11's fifth step the MEA path serves 513 to
    1024 (tests/test_torch_w1024.py), and since its sixth the Viterbi
    path too (tests/test_torch_w1024_viterbi.py), and since its seventh
    the MEA path 1025 to 2048 (tests/test_torch_w2048.py), so each path
    is held to its top, the MEA path refusing 2049 and the Viterbi path
    1025."""
    monkeypatch.setattr(port_realign_stage, "chain_sam_file",
                        _past_the_guard)
    monkeypatch.setattr(dispatch, "pack_stream_pairs", _past_the_guard)
    calls = dict(_mea_entry_points(mapped, tmp_path, 2049),
                 **_viterbi_entry_points(1025))
    for name, call in calls.items():
        with pytest.raises(ValueError, match="C11"):
            call()
    with pytest.raises(ValueError, match="C11"):
        check_band_width(1025, "cuda")
    assert not (tmp_path / "out.sam").exists()
    assert not (tmp_path / "r").exists()


@pytest.mark.parametrize("w", [257, 300, 384, 385, 450, 512])
def test_padded_width_lays_257_to_512_into_384_and_512(w):
    assert padded_width(w) == (384 if w <= 384 else 512)
    assert padded_width(513) == 768  # the W = 768 layout (C11's fifth step)


def test_the_cpu_serves_600(pairs):
    """The CPU runs the plain versions at 600 in the card's W = 768
    layout (since ROADMAP C11's fifth step; unpadded before): the EM
    sums, in 192 lanes of 4 cells (six warps' fold), against the JAX
    package's ``em_expectations`` at the same width."""
    assert padded_width(600) == 768
    assert port_realign.em_width(600) == 768 and em_lanes(768) == 192
    _em_against_jax(pairs[:2], 600)
