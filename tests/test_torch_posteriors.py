"""The port's posterior outputs vs the JAX package, at W = 8.

Fixtures: uniform reads with one substitution each, and the reads of
tests/test_pallas_realign.py::TestEmitExp (an N base, a deletion guide
and an insertion guide).  The port runs its plain versions of the
realign kernel's gamma, decode + gamma and exp modes; the references are

* the gamma_match band of ``nanopore_tpu.ops.pairhmm.forward_backward``
  (rtol 1e-3, atol 1e-5 on the lattice's cells) and of the Pallas kernel
  in interpret mode with ``emit_gamma`` (≤5e-5 on every cell), CHUNK/SEG
  patched small as tests/test_torch_realign.py does;
* the per-read expectation matrices of the JAX
  ``posterior_expectations_batch`` (the XLA retire scan over the
  forward_backward band; rtol 1e-3, atol 2e-3) and of the JAX
  ``posterior_expectations_fused`` over the Pallas ``emit_exp`` streams
  in interpret mode (≤5e-4: both pull the retire rows as f16), at
  thresholds 0 and 1e-3;
* ``path_band_indices`` identical, and ``rescore_cigars`` against the
  JAX ``rescore_cigars`` and ``ops.mea.rescore_by_posterior`` on the
  same band at 1e-5.
"""

import numpy as np
import pytest
import torch

import nanopore_tpu.ops.pairhmm_pallas_realign as ppr
from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.io.sam import CIG
from nanopore_tpu.ops import posteriors as jax_post
from nanopore_tpu.ops.mea import rescore_by_posterior
from nanopore_tpu.ops.pairhmm import forward_backward
from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.ops import dispatch
from nanopore_tpu_torch.ops import posteriors as post
from nanopore_tpu_torch.ops import realign as port_realign
from nanopore_tpu_torch.ops.pack import pack_stream_pairs, pack_xyc
from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
from nanopore_tpu_torch.ops.realign import (
    realign_decode,
    realign_exp,
    realign_exp_plain,
    realign_gamma,
    realign_gamma_plain,
)
from nanopore_tpu_torch.ops.traceback import mea_walk, rle_ops_batch
from test_torch_realign import _far_end_pairs

W = 8
THRESHOLDS = (0.0, 1e-3)


@pytest.fixture(scope="module", autouse=True)
def small_kernel_geometry():
    old_chunk, old_seg = ppr.CHUNK, ppr.SEG
    ppr.CHUNK = 8
    ppr.SEG = 4
    yield
    ppr.CHUNK, ppr.SEG = old_chunk, old_seg
    ppr._pallas_realign_call.clear_cache()


def uniform_pairs(rng):
    pairs = []
    for _ in range(3):
        x = rng.integers(0, 4, 14).astype(np.int8)
        y = x.copy()
        idx = rng.integers(0, 14, 1)
        y[idx] = (y[idx] + 1) % 4
        pairs.append((x, y, [(CIG.M, 14)]))
    return pairs


def n_del_ins_pairs(rng):
    pairs = []
    x0 = rng.integers(0, 4, 16).astype(np.int8)
    y0 = x0.copy()
    y0[rng.integers(0, 16, 4)] = rng.integers(0, 4, 4)
    y0[3] = 4  # N base: bins nowhere
    pairs.append((x0, y0, [(CIG.M, 16)]))
    x1 = rng.integers(0, 4, 14).astype(np.int8)
    pairs.append((x1, x1[:9].copy(), [(CIG.M, 4), (CIG.D, 5), (CIG.M, 5)]))
    x2 = rng.integers(0, 4, 10).astype(np.int8)
    y2 = np.concatenate([x2[:5], rng.integers(0, 4, 4).astype(np.int8),
                         x2[5:]])
    pairs.append((x2, y2, [(CIG.M, 5), (CIG.I, 4), (CIG.M, 5)]))
    return pairs


FIXTURES = {
    "uniform": (uniform_pairs, 7),
    "n_base_del_ins_guides": (n_del_ins_pairs, 31),
}


def _case(name):
    make, seed = FIXTURES[name]
    pairs = make(np.random.default_rng(seed))
    return pairs, prepare_banded_batch(pairs, band_width=W)


def _packed(pairs, k_max=None):
    prep = pack_stream_pairs(pairs, W, k_max)
    t = torch.from_numpy
    m, n = t(prep["m"]), t(prep["n"])
    xyc = pack_xyc(t(prep["stream"]), t(prep["initx"]), m, n)
    return prep, xyc, m, n


def _params():
    return make_kernel_params(PairHmmModel.default())


def _valid_cells(offsets_b, K1, m, n):
    ks = np.arange(K1)[:, None]
    j = offsets_b[:K1, None] + np.arange(W)[None, :]
    i = ks - j
    return (i >= 1) & (i <= m) & (j >= 1) & (j <= n)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_gamma_band_matches_forward_backward(name):
    pairs, batch = _case(name)
    fb = forward_backward(batch, jax_params(JaxModel.default()))
    want = np.asarray(fb["gamma_match"])
    prep, xyc, m, n = _packed(pairs, batch.k_max)
    got = realign_gamma(xyc, m, n, _params())
    np.testing.assert_allclose(got["loglik"].numpy(),
                               np.asarray(fb["loglik"]), rtol=1e-5)
    band = got["gamma"].numpy()
    offsets = np.asarray(batch.offsets)
    assert np.array_equal(prep["offsets"][:, :offsets.shape[1]], offsets)
    for b, (x, y, _) in enumerate(pairs):
        valid = _valid_cells(offsets[b], want.shape[1], len(y), len(x))
        np.testing.assert_allclose(band[b][:want.shape[1]][valid],
                                   want[b][valid], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_gamma_band_matches_pallas_interpret(name):
    pairs, batch = _case(name)
    plan = ppr.PallasRealignPlan(batch, jax_params(JaxModel.default()),
                                 emit_gamma=True, emit_em=False)
    raw = plan.run(interpret=True)
    want = ppr.gamma_band_from_raw(raw["gamma_raw"], len(pairs), batch.k_max)
    _, xyc, m, n = _packed(pairs, batch.k_max)
    got = realign_gamma(xyc, m, n, _params())["gamma"].numpy()
    K1 = want.shape[1]
    assert np.abs(got[:, :K1] - want).max() <= 5e-5
    # the band past the batch's last diagonal holds no mass
    assert np.abs(got[:, K1:]).max() <= 5e-5


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_decode_gamma_mode_is_decode_plus_the_gamma_band(name):
    pairs, batch = _case(name)
    _, xyc, m, n = _packed(pairs, batch.k_max)
    both = realign_decode(xyc, m, n, _params(), emit_gamma=True)
    dec = realign_decode(xyc, m, n, _params())
    gam = realign_gamma(xyc, m, n, _params())
    for key in ("loglik", "score", "dirs"):
        assert torch.equal(both[key], dec[key])
    assert torch.equal(both["gamma"], gam["gamma"])
    assert torch.equal(both["loglik"], gam["loglik"])


@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_expectations_match_xla_retire_scan(name, thr):
    pairs, batch = _case(name)
    offsets = np.asarray(batch.offsets)
    ns = np.asarray(batch.n)
    fb = forward_backward(batch, jax_params(JaxModel.default()))
    want = jax_post.posterior_expectations_batch(
        fb["gamma_match"], batch.yc, offsets, ns, threshold=thr)
    prep, xyc, m, n = _packed(pairs, batch.k_max)
    out = realign_exp(xyc, m, n, _params(), thr)
    got = post.posterior_expectations_fused(
        out["ret"], out["flush"], prep["offsets"], prep["n"], W)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_expectations_match_pallas_interpret_emit_exp(name, thr):
    pairs, batch = _case(name)
    offsets = np.asarray(batch.offsets)
    ns = np.asarray(batch.n)
    plan = ppr.PallasRealignPlan(batch, jax_params(JaxModel.default()),
                                 emit_em=False, emit_exp=True,
                                 exp_threshold=thr)
    raw = plan.run(interpret=True)
    want = jax_post.posterior_expectations_fused(
        raw["ret_raw"], raw["flush_raw"], offsets, ns, W)
    prep, xyc, m, n = _packed(pairs, batch.k_max)
    out = dispatch.PreparedPosteriors(
        None, _params(), xyc, m, n, emit_gamma=False, emit_exp=True,
        exp_threshold=thr).run()
    got = post.expectations_from_post(out, prep["offsets"], prep["n"], W)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 5e-4


def test_exp_threshold_drops_small_gammas():
    """At a threshold above every gamma nothing bins: all zeros."""
    pairs, batch = _case("n_base_del_ins_guides")
    prep, xyc, m, n = _packed(pairs, batch.k_max)
    out = realign_exp(xyc, m, n, _params(), 2.0)
    assert not out["ret"].any() and not out["flush"].any()
    assert torch.equal(out["loglik"],
                       realign_gamma(xyc, m, n, _params())["loglik"])


def _random_cigars(rng, count=20):
    cigars = []
    for _ in range(count):
        cig = []
        for _ in range(int(rng.integers(1, 8))):
            op = (CIG.M, CIG.M, CIG.I, CIG.D, CIG.EQ, CIG.X, CIG.N)[
                int(rng.integers(0, 7))]
            cig.append((op, int(rng.integers(1, 9))))
        cigars.append(cig)
    return cigars


def test_path_band_indices_identical():
    rng = np.random.default_rng(5)
    for cig in _random_cigars(rng):
        i = sum(ln for op, ln in cig if op in (CIG.M, CIG.EQ, CIG.X, CIG.I))
        j = sum(ln for op, ln in cig
                if op in (CIG.M, CIG.EQ, CIG.X, CIG.D, CIG.N))
        K1 = i + j + 1
        offsets = np.maximum(0, (np.arange(K1) - W) // 2).astype(np.int32)
        for band_width in (4, W):
            got = post.path_band_indices(cig, offsets, band_width)
            want = jax_post.path_band_indices(cig, offsets, band_width)
            assert got[1] == want[1]
            assert np.array_equal(got[0], want[0])


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_rescore_cigars_matches_jax_on_the_same_band(name):
    pairs, batch = _case(name)
    prep, xyc, m, n = _packed(pairs, batch.k_max)
    out = dispatch.PreparedRealign(None, _params(), xyc, m, n,
                                   emit_gamma=True).run()
    mea = rle_ops_batch(mea_walk(out["dirs"], xyc, m, n).numpy())
    band = out["gamma"].numpy()
    offsets = prep["offsets"]
    for cigars in ([g for _, _, g in pairs], mea):
        got = post.rescore_from_post(out, offsets, cigars, W)
        want = jax_post.rescore_cigars(band, offsets, cigars, W)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        for b, cig in enumerate(cigars):
            assert got[b] == pytest.approx(
                rescore_by_posterior(band[b], offsets[b], cig),
                rel=1e-5, abs=1e-5)
            assert 0.0 < got[b] <= 1.0 + 1e-5
    # a cigar with no aligned pair scores NaN, as in the JAX package
    empty = [[(CIG.D, len(x)), (CIG.I, len(y))] for x, y, _ in pairs]
    assert all(np.isnan(post.rescore_cigars(out["gamma"], offsets, empty, W)))


def test_prepared_posteriors_routes_and_checks():
    pairs, _ = _case("n_base_del_ins_guides")
    params = _params()
    prepared = dispatch.prepared_from_pairs(
        {"device": "cpu"}, pairs, params, band_width=W,
        prepared_cls=dispatch.PreparedPosteriors)
    gam = prepared.launch().run()
    prep, xyc, m, n = _packed(pairs, prepared.xyc.shape[1])
    assert torch.equal(gam["gamma"],
                       realign_gamma_plain(xyc, m, n, params)["gamma"])
    exp = dispatch.prepared_from_pairs(
        {"device": "cpu", "emit_gamma": False, "emit_exp": True,
         "exp_threshold": 1e-3}, pairs, params, band_width=W,
        prepared_cls=dispatch.PreparedPosteriors).run()
    want = realign_exp_plain(xyc, m, n, params, 1e-3)
    assert torch.equal(exp["ret"], want["ret"])
    assert torch.equal(exp["flush"], want["flush"])
    with pytest.raises(ValueError):
        dispatch.PreparedPosteriors(None, params, xyc, m, n,
                                    emit_gamma=True, emit_exp=True)
    with pytest.raises(ValueError, match="emit_gamma"):
        post.rescore_from_post(exp, prep["offsets"], [], W)
    with pytest.raises(ValueError, match="emit_exp"):
        post.expectations_from_post(gam, prep["offsets"], prep["n"], W)
    realign = dispatch.prepared_from_pairs(
        {"device": "cpu", "emit_gamma": True}, pairs, params, band_width=W)
    assert realign.has_gamma
    assert torch.equal(realign.run()["gamma"], gam["gamma"])


def test_cpu_route_counts_no_launch():
    """Each mode's counter counts kernel launches only: the plain
    versions that CPU tensors run add nothing."""
    pairs, _ = _case("n_base_del_ins_guides")
    prep, xyc, m, n = _packed(pairs)
    counters = (port_realign.LAUNCHES, port_realign.GAMMA_LAUNCHES,
                port_realign.DECODE_GAMMA_LAUNCHES, port_realign.EXP_LAUNCHES)
    before = [c.count for c in counters]
    realign_decode(xyc, m, n, _params(), emit_gamma=True)
    realign_decode(xyc, m, n, _params())
    realign_gamma(xyc, m, n, _params())
    realign_exp(xyc, m, n, _params(), 1e-3)
    assert [c.count for c in counters] == before
    assert len({c.name for c in counters}) == len(counters)


def test_padding_diagonals_do_not_change_posteriors():
    pairs, _ = _case("n_base_del_ins_guides")
    params = _params()
    short = _packed(pairs)
    long_ = _packed(pairs, 300)
    g_s = realign_gamma(*short[1:], params)
    g_l = realign_gamma(*long_[1:], params)
    K1 = g_s["gamma"].shape[1]
    assert torch.equal(g_s["gamma"], g_l["gamma"][:, :K1])
    assert not g_l["gamma"][:, K1:].any()
    e_s = realign_exp(*short[1:], params, 1e-3)
    e_l = realign_exp(*long_[1:], params, 1e-3)
    x_s = post.posterior_expectations_fused(
        e_s["ret"], e_s["flush"], short[0]["offsets"], short[0]["n"], W)
    x_l = post.posterior_expectations_fused(
        e_l["ret"], e_l["flush"], long_[0]["offsets"], long_[0]["n"], W)
    for a, b in zip(x_s, x_l):
        assert np.array_equal(a, b)


def test_short_read_beside_one_five_times_longer_posteriors():
    """A read's gamma band, retire rows and flush are bit-identical
    beside a read five times longer and alone; its rows past m + n are
    0 in the gamma band and the retire rows."""
    pairs = _far_end_pairs(3)
    params = _params()
    prep2, *both = _packed(pairs)
    prep1, *alone = _packed(pairs[:1])
    kend = int(prep2["k_end"][0])
    g2, g1 = realign_gamma(*both, params), realign_gamma(*alone, params)
    K1 = g1["gamma"].shape[1]
    assert torch.equal(g2["loglik"][0], g1["loglik"][0])
    assert torch.equal(g2["gamma"][0, :K1], g1["gamma"][0])
    assert not g2["gamma"][0, kend + 1:].any()
    e2 = realign_exp(*both, params, 1e-3)
    e1 = realign_exp(*alone, params, 1e-3)
    assert torch.equal(e2["ret"][0, :K1], e1["ret"][0])
    assert torch.equal(e2["flush"][0], e1["flush"][0])
    assert not e2["ret"][0, kend + 1:].any()
    d2 = realign_decode(*both, params, emit_gamma=True)
    d1 = realign_decode(*alone, params, emit_gamma=True)
    assert torch.equal(d2["gamma"][0, :K1], d1["gamma"][0])
    assert torch.equal(d2["dirs"][0, :K1], d1["dirs"][0])
    assert (d2["dirs"][0, kend + 1:] == port_realign.DIR_NONE).all()
