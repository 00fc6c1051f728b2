"""Every band width from 2 to 64 in the port's W = 32 and W = 64 layouts,
on the CPU, against the JAX package's XLA-scan route at the same width.

A band of live width w lies in the first w lanes of W = 32 lanes if
w <= 32, else of W = 64 (``ops.pack.padded_width``), its dead lanes all
sentinel; ``prepared_from_pairs`` lays every batch out so on either
device, so these tests run what the card runs.  At w in {21, 33, 48},
and at 32 and 64, where the layout has no dead lane:

* the packed codes: lanes < w those of the JAX package's packs at w
  (``pack_pallas_pairs``, and ``prepare_pallas_realign`` over
  ``prepare_banded_batch``), lanes >= w the sentinel with the row's
  bits 6-7, and ``prepared_from_pairs`` lays them out so;
* every realign mode (decode, decode + gamma, gamma, exp, EM), the
  forward-only loglik and the Viterbi in the padded layout give, bit for
  bit in the live lanes, what the plain versions give on the unpadded
  band of width w, packed and run by the calls that take no live width
  (so the dead lanes add exactly nothing; at 32 and 64, where there is
  none, that is the path before the layout existed), and the run
  outputs of the prepared batches slice the gamma band and the flush to
  w;
* against the JAX package at w: realign loglik ≤ 1e-5 relative with
  identical MEA cigars (``ops.mea.realign_fused``); the gamma band
  ≤ 5e-5 on every lattice cell (``forward_backward``); the retire rows
  and flush, scattered into per-read expectation matrices in f32,
  ≤ 5e-5 (``expectation_streams``), and ``expectations_from_post`` over
  a prepared batch at the f16 bars of tests/test_torch_posteriors.py;
  the Viterbi score ≤ 1e-5 relative with identical cigars
  (``viterbi_decode_batch``); the forward-only loglik ≤ 1e-5
  (``forward_loglik``);
* the E-step's batch (``PreparedEm``): each read's EM sums within 3e-5
  of each table's largest entry (``em_expectations``), at those widths
  and at 96, which both devices lay into W = 128 (the wide band's own
  tests are tests/test_torch_wide.py); ``em_train`` at w = 21 and 48: the trained transitions and
  emissions within 3e-5 relative of the JAX package's ``em_train``;
* ``realign_sam_file`` at w = 21, 33 and 48: every record equal to the
  JAX package's;
* on random codes at w = 21 no MEA or Viterbi op leaves the live band,
  and every dead lane's direction code is DIR_NONE;
* ``check_band_width``: on the card the MEA path serves 2 to 2048 and
  the Viterbi path 2 to 1024, and their kernel wrappers take the layout a
  served width is laid into and refuse a wider band's; the CPU serves
  any width on either.
"""

import numpy as np
import pytest
import torch

from nanopore_tpu.align import em as jax_em
from nanopore_tpu.align import realign as jax_realign
from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.io.sam import CIG
from nanopore_tpu.ops import posteriors as jax_post
from nanopore_tpu.ops.mea import mea_traceback_fwd, realign_fused
from nanopore_tpu.ops.pairhmm import em_expectations, forward_backward
from nanopore_tpu.ops.pairhmm import forward_loglik as jax_forward_loglik
from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu.ops.pairhmm_pallas_realign import (
    pack_pallas_pairs,
    prepare_pallas_realign,
)
from nanopore_tpu.ops.viterbi import viterbi_decode_batch, viterbi_traceback
from nanopore_tpu_torch.align import em as port_em
from nanopore_tpu_torch.align import realign as port_realign_stage
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.ops import dispatch
from nanopore_tpu_torch.ops import posteriors as post
from nanopore_tpu_torch.ops.forward import forward_loglik
from nanopore_tpu_torch.ops.pack import (
    SENT,
    check_band_width,
    pack_stream_pairs,
    pack_xyc,
    padded_width,
)
from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
from nanopore_tpu_torch.ops.realign import (
    DIR_NONE,
    realign_decode,
    realign_em,
    realign_exp,
    realign_gamma,
    untile,
)
from nanopore_tpu_torch.ops.traceback import (
    mea_walk,
    rle_ops_batch,
    viterbi_walk,
)
from nanopore_tpu_torch.ops.viterbi import viterbi_forward
from test_torch_chain_realign import mapped, sam_records  # noqa: F401
from test_torch_em import _global_pairs
from test_torch_viterbi import _past_the_width_check, _PastTheWidthCheck

PADDED = (21, 33, 48)
IDENTITY = (32, 64)
WIDTHS = PADDED + IDENTITY
THRESHOLD = 1e-3


def width_pairs(seed=13):
    """Reads of 90-140 bases against windows of their reference: pure
    match, a long deletion and a long insertion (the path crosses half
    a narrow band), leading and trailing indels, N bases in both."""
    rng = np.random.default_rng(seed)
    pairs = []
    for cig in [
        [(CIG.M, 120)],
        [(CIG.M, 50), (CIG.D, 14), (CIG.M, 60)],
        [(CIG.M, 45), (CIG.I, 12), (CIG.M, 50)],
        [(CIG.I, 6), (CIG.M, 70), (CIG.D, 9), (CIG.M, 30)],
        [(CIG.D, 11), (CIG.M, 80), (CIG.I, 5)],
    ]:
        n = sum(ln for op, ln in cig if op in (CIG.M, CIG.D))
        m = sum(ln for op, ln in cig if op in (CIG.M, CIG.I))
        x = rng.integers(0, 4, n).astype(np.int8)
        # the read follows the guide with 8 % substitutions and N bases
        y, i, j = np.empty(m, np.int8), 0, 0
        for op, ln in cig:
            if op == CIG.M:
                y[i:i + ln] = x[j:j + ln]
                i, j = i + ln, j + ln
            elif op == CIG.I:
                y[i:i + ln] = rng.integers(0, 4, ln)
                i += ln
            else:
                j += ln
        sub = rng.random(m) < 0.08
        y[sub] = rng.integers(0, 4, int(sub.sum()))
        y[rng.integers(0, m, 2)] = 4
        x[rng.integers(0, n, 1)] = 4
        pairs.append((x, y, cig))
    return pairs


@pytest.fixture(scope="module")
def pairs():
    return width_pairs()


def _params():
    return make_kernel_params(PairHmmModel.default())


def _jparams():
    return jax_params(JaxModel.default())


def _packed(pairs, w, lanes=None, k_max=None):
    """The port's packed batch of live width w in ``lanes`` lanes; with
    no ``lanes``, the unpadded band, packed by the calls that take no
    live width."""
    prep = pack_stream_pairs(pairs, w, k_max, lanes=lanes)
    t = torch.from_numpy
    m, n = t(prep["m"]), t(prep["n"])
    live = {} if lanes is None else {"band_width": w}
    xyc = pack_xyc(t(prep["stream"]), t(prep["initx"]), m, n, **live)
    return prep, xyc, m, n


@pytest.fixture(scope="module")
def layouts(pairs):
    """Per width: the padded batch, the unpadded one, and the JAX
    package's banded batch over the same diagonals."""
    out = {}
    for w in WIDTHS:
        pad = _packed(pairs, w, padded_width(w))
        k_pad = pad[0]["k_pad"]
        out[w] = {
            "pad": pad,
            "bare": _packed(pairs, w),
            "jax": prepare_banded_batch(pairs, band_width=w, k_max=k_pad),
        }
    return out


def _valid_cells(offsets_b, K1, w, m, n):
    ks = np.arange(K1)[:, None]
    j = offsets_b[:K1, None] + np.arange(w)[None, :]
    i = ks - j
    return (i >= 1) & (i <= m) & (j >= 1) & (j <= n)


# ---- the layout ---------------------------------------------------------- #

@pytest.mark.parametrize("w", WIDTHS)
def test_packed_codes_are_jax_codes_then_sentinel_lanes(pairs, layouts, w):
    prep, xyc, _, _ = layouts[w]["pad"]
    W = padded_width(w)
    assert W == (32 if w <= 32 else 64) and prep["W"] == W
    assert prep["band_width"] == w
    codes = xyc.numpy().view(np.uint8)
    B, k_pad = len(pairs), prep["k_pad"]
    assert codes.shape == (B, k_pad, W)
    jp = _jparams()
    host = untile(pack_pallas_pairs(pairs, jp, band_width=w,
                                    k_max=k_pad)["xyc"], B).view(np.uint8)
    np.testing.assert_array_equal(codes[:, :, :w], host)
    repacked = prepare_pallas_realign(layouts[w]["jax"], jp)
    np.testing.assert_array_equal(
        codes[:, :, :w], untile(repacked["xyc"], B).view(np.uint8)[:, :k_pad])
    np.testing.assert_array_equal(
        prep["offsets"], np.asarray(layouts[w]["jax"].offsets))
    dead = codes[:, :, w:]
    assert (dead & 0x3F == SENT).all()
    assert (dead & 0xC0 == codes[:, :, :1] & 0xC0).all()
    # the dispatch layer lays every batch out so, on the CPU as on the card
    disp = dispatch.prepared_from_pairs({"device": "cpu"}, pairs, _params(),
                                        band_width=w, k_max=k_pad,
                                        exact_k=True)
    assert disp.batch.band_width == w
    assert torch.equal(disp.xyc, xyc)


def _modes(batch, w=None):
    """Every realign mode and the forward-only and Viterbi outputs of one
    packed batch at live width w (``None``: every lane, passed as the
    calls before the layout existed pass it: not at all)."""
    _, xyc, m, n = batch
    p = _params()
    live = {} if w is None else {"band_width": w}
    return {
        "decode": realign_decode(xyc, m, n, p, emit_gamma=True, **live),
        "gamma": realign_gamma(xyc, m, n, p, **live),
        "exp": realign_exp(xyc, m, n, p, THRESHOLD, **live),
        "em": realign_em(xyc, m, n, p, **live),
        "forward": {"loglik": forward_loglik(xyc, m, n, p)},
        "viterbi": viterbi_forward(xyc, m, n, p),
    }


@pytest.mark.parametrize("w", WIDTHS)
def test_padded_layout_gives_the_unpadded_bits(layouts, w):
    """The dead lanes add exactly nothing: each output's live lanes are
    the unpadded band's, bit for bit; the dead lanes hold DIR_NONE in
    the direction codes and 0 in the gamma band and the flush.  (EM's
    lane butterfly lays the unpadded band into the next power of two
    too.)"""
    assert torch.equal(layouts[w]["pad"][1][:, :, :w], layouts[w]["bare"][1])
    got = _modes(layouts[w]["pad"], w)
    want = _modes(layouts[w]["bare"])
    for mode in got:
        for key, a in got[mode].items():
            if key in ("dirs", "gamma", "bp", "flush"):
                a = a[:, :, :w]
            assert torch.equal(a, want[mode][key]), (mode, key)
    if w in PADDED:
        assert (got["decode"]["dirs"][:, :, w:] == DIR_NONE).all()
        assert (got["decode"]["gamma"][:, :, w:] == 0).all()
        assert (got["gamma"]["gamma"][:, :, w:] == 0).all()
        assert (got["exp"]["flush"][:, :, w:] == 0).all()


def _prepared(pairs, w, kwargs, **extra):
    """A prepared batch on the CPU over the layouts' diagonals."""
    k_pad = pack_stream_pairs(pairs, w)["k_pad"]
    return dispatch.prepared_from_pairs(
        dict(kwargs, device="cpu"), pairs, _params(), band_width=w,
        k_max=k_pad, exact_k=True, **extra)


EXP_KW = {"emit_gamma": False, "emit_exp": True, "exp_threshold": THRESHOLD}


@pytest.mark.parametrize("w", PADDED)
def test_prepared_batches_slice_band_outputs_to_the_live_width(pairs, w):
    pairs = pairs[:2]
    gam = _prepared(pairs, w, {},
                    prepared_cls=dispatch.PreparedPosteriors).run()
    exp = _prepared(pairs, w, EXP_KW,
                    prepared_cls=dispatch.PreparedPosteriors).run()
    out = _prepared(pairs, w, {"emit_gamma": True}).run()
    assert gam["gamma"].shape[2] == w and exp["flush"].shape[2] == w
    assert out["gamma"].shape[2] == w
    assert out["dirs"].shape[2] == padded_width(w)  # the walker's layout
    assert torch.equal(out["gamma"], gam["gamma"])


# ---- against the JAX package's XLA scan at the same width ---------------- #

@pytest.mark.parametrize("w", WIDTHS)
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


@pytest.mark.parametrize("w", WIDTHS)
def test_gamma_band_matches_forward_backward(pairs, layouts, w):
    batch = layouts[w]["jax"]
    fb = forward_backward(batch, _jparams())
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


def _expectations_f32(ret, flush, offsets, ns, w):
    """posterior_expectations_fused's scatter on the f32 streams (no f16
    pull), so the comparison sees the kernel's own sums."""
    ret, flush = ret.numpy(), flush.numpy()
    out = []
    for b in range(len(ns)):
        n, o = int(ns[b]), offsets[b]
        kmax = min(len(o) - 1, ret.shape[1] - 1)
        rows = np.nonzero(o[1:kmax + 1] - o[:kmax])[0]
        pos = o[rows + 1] + w - 2
        ok = (pos >= 0) & (pos < n)
        e = np.zeros((n, 4), np.float32)
        e[pos[ok]] += ret[b, rows[ok]]
        fpos = np.arange(w) - 1
        fok = (fpos >= 0) & (fpos < n)
        e[fpos[fok]] += flush[b][:, fok].T
        out.append(e)
    return out


@pytest.mark.parametrize("w", WIDTHS)
def test_retire_rows_and_flush_match_the_xla_retire_scan(pairs, layouts, w):
    batch = layouts[w]["jax"]
    offsets = np.asarray(batch.offsets)
    ns = np.asarray(batch.n)
    fb = forward_backward(batch, _jparams())
    want = jax_post.posterior_expectations_batch(
        fb["gamma_match"], batch.yc, offsets, ns, threshold=THRESHOLD)
    prepared = _prepared(pairs, w, EXP_KW,
                         prepared_cls=dispatch.PreparedPosteriors)
    out = prepared.run()  # ret and the flush sliced to the live width
    lite = prepared.batch
    got = _expectations_f32(out["ret"], out["flush"], lite.offsets, lite.n,
                            w)
    for g, e in zip(got, want):
        assert g.shape == e.shape
        assert np.abs(g - e).max() <= 5e-5
    # the consumer's route: the retire rows pulled as f16
    fused = post.expectations_from_post(out, lite.offsets, lite.n, w)
    for g, e in zip(fused, want):
        np.testing.assert_allclose(g, e, rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("w", WIDTHS)
def test_viterbi_matches_viterbi_decode_batch(pairs, layouts, w):
    batch = layouts[w]["jax"]
    scores, fstates, bps = viterbi_decode_batch(batch, _jparams())
    prep, xyc, m, n = layouts[w]["pad"]
    got = viterbi_forward(xyc, m, n, _params())
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(scores),
                               rtol=1e-5)
    ops, end = viterbi_walk(got["bp"], xyc, m, n, got["fstate"])
    assert not end.any()
    cigars = rle_ops_batch(ops.numpy())
    offsets = np.asarray(batch.offsets)
    bps, fstates = np.asarray(bps), np.asarray(fstates)
    for b, (x, y, _) in enumerate(pairs):
        assert cigars[b] == viterbi_traceback(bps[b], offsets[b], len(y),
                                              len(x), int(fstates[b]))


@pytest.mark.parametrize("w", WIDTHS)
def test_forward_loglik_matches_jax(layouts, w):
    want = np.asarray(jax_forward_loglik(layouts[w]["jax"], _jparams()))
    _, xyc, m, n = layouts[w]["pad"]
    got = forward_loglik(xyc, m, n, _params()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("w", WIDTHS + (96,))
def test_em_sums_match_em_expectations(pairs, w):
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


@pytest.mark.parametrize("w", [21, 48])
def test_em_train_matches_jax_em_train(w):
    pairs = _global_pairs(count=4)
    opts = dict(trials=1, iterations=2, band_width=w, seed=3, window_pad=32)
    got = port_em.em_train(pairs, port_em.EmOptions(batch_size=8, **opts),
                           device="cpu")
    want = jax_em.em_train(pairs, jax_em.EmOptions(use_mesh=False, **opts))
    np.testing.assert_allclose(got.running_likelihoods[0],
                               want.running_likelihoods[0], rtol=1e-5)
    np.testing.assert_allclose(got.model.transitions, want.model.transitions,
                               rtol=3e-5)
    np.testing.assert_allclose(got.model.emissions, want.model.emissions,
                               rtol=3e-5)


@pytest.mark.parametrize("w", PADDED)
def test_realign_sam_file_matches_jax(mapped, w):  # noqa: F811
    d = mapped["dir"]
    jax_realign.realign_sam_file(
        mapped["sam"], str(d / ("j_w%d.sam" % w)), mapped["fq"],
        mapped["fa"], band_width=w)
    port_realign_stage.realign_sam_file(
        mapped["sam"], str(d / ("p_w%d.sam" % w)), mapped["fq"],
        mapped["fa"], band_width=w, device="cpu")
    got = sam_records(str(d / ("p_w%d.sam" % w)))
    assert len(got) == 8
    assert got == sam_records(str(d / ("j_w%d.sam" % w)))


# ---- no op leaves the live band ------------------------------------------ #

def _lanes_walked(cigar, offsets_b, m, n):
    """The band lane of every lattice cell a cigar's path visits."""
    i = j = 0
    lanes = [j - offsets_b[0]]
    for op, ln in cigar:
        for _ in range(ln):
            if op == CIG.M:
                i, j = i + 1, j + 1
            elif op == CIG.I:
                i += 1
            else:
                j += 1
            lanes.append(j - offsets_b[i + j])
    assert (i, j) == (m, n)
    return np.array(lanes)


def test_no_op_leaves_the_live_band_on_random_codes():
    """Unrelated random sequences under random guides at w = 21: the
    paths press on the band's edges, and neither decode leaves lanes
    0..20 of its 32."""
    rng = np.random.default_rng(21)
    w = 21
    pairs = []
    for _ in range(6):
        n, m = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        d = int(rng.integers(0, min(n, m)))
        guide = [(CIG.M, d), (CIG.D, n - d), (CIG.I, m - d)]
        pairs.append((rng.integers(0, 5, n).astype(np.int8),
                      rng.integers(0, 5, m).astype(np.int8), guide))
    prep, xyc, m, n = _packed(pairs, w, padded_width(w))
    p = _params()
    dec = realign_decode(xyc, m, n, p, band_width=w)
    assert (dec["dirs"][:, :, w:] == DIR_NONE).all()
    mea = rle_ops_batch(mea_walk(dec["dirs"], xyc, m, n).numpy())
    vit = viterbi_forward(xyc, m, n, p)
    ops, end = viterbi_walk(vit["bp"], xyc, m, n, vit["fstate"])
    assert not end.any()
    for cigars in (mea, rle_ops_batch(ops.numpy())):
        for b, (x, y, _) in enumerate(pairs):
            lanes = _lanes_walked(cigars[b], prep["offsets"][b], len(y),
                                  len(x))
            assert lanes.min() >= 0 and lanes.max() < w


# ---- the widths the card serves (ROADMAP C10) ---------------------------- #

GUARD_WIDTHS = (1, 2, 21, 32, 33, 48, 64, 65, 96, 128, 129, 160, 257, 384,
                512, 513, 768, 1024, 1025, 1536, 2048, 2049)


def _path_wrappers(path, W):
    """The kernel wrappers of ``path`` on a ``meta`` batch of W lanes (the
    meta device stands in for the card), as callables: the MEA path's
    pack and walker, the Viterbi path's Viterbi, walker and forward-only
    kernel."""
    meta = dict(device="meta")
    xyc = torch.zeros((2, 64, W), dtype=torch.int8, **meta)
    rows = torch.zeros((2, 65, W), dtype=torch.int8, **meta)

    def i32():
        return torch.zeros(2, dtype=torch.int32, **meta)

    if path == "mea":
        return [lambda: pack_xyc(torch.zeros((2, 64), dtype=torch.uint8,
                                             **meta),
                                 torch.zeros((2, W), dtype=torch.uint8,
                                             **meta), i32(), i32()),
                lambda: mea_walk(rows, xyc, i32(), i32())]
    return [lambda: viterbi_forward(xyc, i32(), i32(), _params()),
            lambda: viterbi_walk(rows, xyc, i32(), i32(), i32()),
            lambda: forward_loglik(xyc, i32(), i32(), _params())]


@pytest.mark.parametrize("path", ["mea", "viterbi"])
@pytest.mark.parametrize("w", GUARD_WIDTHS)
def test_check_band_width_serves_each_path_on_the_card(path, w,
                                                       monkeypatch):
    """On the card the MEA path (pack, realign, MEA walker) serves 2 to
    2048 (since ROADMAP C11's seventh step; 2 to 1024 since its fifth, 2
    to 512 since its third) and the Viterbi path (pack, Viterbi, its
    walker, forward-only) 2 to 1024 (since its sixth step; 2 to 512
    since its fourth, 2 to 256 before, 2 to 128 before its second), one
    guard that knows the path, and each path's kernel wrappers take the
    layout a served width is laid into past their width check, and
    refuse a wider band's; the CPU serves any width; each live width is
    laid into the narrowest of 32, 64, 128, 256, 384, 512, 768, 1024,
    1536 and 2048 lanes that holds it."""
    monkeypatch.setattr("nanopore_tpu_torch.kernels.build.library",
                        _past_the_width_check)
    top = 2048 if path == "mea" else 1024
    served = 2 <= w <= top
    for device in ("cuda", None):
        if served:
            check_band_width(w, device, path)
        else:
            with pytest.raises(ValueError, match="C10"):
                check_band_width(w, device, path)
    check_band_width(w, "cpu", path)
    want = next((W for W in (32, 64, 128, 256, 384, 512, 768, 1024, 1536,
                             2048) if w <= W), w)
    assert padded_width(w) == want
    for call in _path_wrappers(path, want):
        if w <= top:
            with pytest.raises(_PastTheWidthCheck):
                call()
        else:
            with pytest.raises(ValueError, match="serves? W"):
                call()
