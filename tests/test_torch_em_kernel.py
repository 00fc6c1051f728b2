"""Port's plain EM-mode realign vs the JAX package's E-step.

Two references on the fixtures of tests/test_torch_realign.py (uniform
reads, N bases with an indel guide, mixed band geometry), at W = 8, for
the default model and one ``PairHmmModel.random`` draw:

* (a) ``nanopore_tpu.ops.pairhmm.em_expectations`` (the XLA scan);
* (b) the Pallas kernel in interpret mode (``emit_em`` on), with its
  CHUNK/SEG patched small as tests/test_pallas_realign.py does.

Bars: loglik rtol 1e-5; trans and emis within 3e-5 of each table's
largest entry, per read (the JAX package's own EM parity bar).  The port
sums each lane's cells and then the lanes by a butterfly, the references
sum in other orders: only f32 rounding differs.

Mutation check (made in a scratch copy, not kept here): with ``new`` in
place of ``dest`` in ``_realign_plain``'s transition sum, every case of
``test_em_plain_matches_xla_em_expectations`` fails.
"""

import numpy as np
import pytest
import torch

import nanopore_tpu.ops.pairhmm_pallas_realign as ppr
from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.ops.pairhmm import em_expectations
from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.ops import realign as port_realign
from nanopore_tpu_torch.ops.dispatch import PreparedEm, prepared_from_pairs
from nanopore_tpu_torch.ops.pack import pack_stream_pairs, pack_xyc
from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
from nanopore_tpu_torch.ops.realign import (
    pad_lanes,
    realign_em,
    realign_em_plain,
)
from test_torch_realign import FIXTURES, W, _far_end_pairs, mixed_pairs

MODELS = ("default", "random")


@pytest.fixture(scope="module", autouse=True)
def small_kernel_geometry():
    old_chunk, old_seg = ppr.CHUNK, ppr.SEG
    ppr.CHUNK = 8
    ppr.SEG = 4
    yield
    ppr.CHUNK, ppr.SEG = old_chunk, old_seg
    ppr._pallas_realign_call.clear_cache()


def _models(which):
    """The same model in both packages (``random``: the same draws of
    one numpy stream)."""
    if which == "default":
        return JaxModel.default(), PairHmmModel.default()
    return (JaxModel.random(np.random.default_rng(5)),
            PairHmmModel.random(np.random.default_rng(5)))


def _xyc(pairs, K=None):
    prep = pack_stream_pairs(pairs, W, K)
    t = torch.from_numpy
    m, n = t(prep["m"]), t(prep["n"])
    return pack_xyc(t(prep["stream"]), t(prep["initx"]), m, n), m, n


def _assert_em_close(got, want, B):
    np.testing.assert_allclose(got["loglik"].numpy(),
                               np.asarray(want["loglik"]), rtol=1e-5)
    for key in ("trans", "emis"):
        w = np.asarray(want[key]).reshape(B, -1)
        g = got[key].numpy().reshape(B, -1)
        assert g.shape == w.shape
        rel = np.abs(g - w).max(axis=1) / np.abs(w).max(axis=1)
        assert rel.max() <= 3e-5, (key, rel)


@pytest.mark.parametrize("which", MODELS)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_em_plain_matches_xla_em_expectations(name, which):
    make, seed = FIXTURES[name]
    pairs = make(np.random.default_rng(seed))
    jm, pm = _models(which)
    batch = prepare_banded_batch(pairs, band_width=W)
    want = em_expectations(batch, jax_params(jm), segment_size=8)
    xyc, m, n = _xyc(pairs, batch.k_max)
    got = realign_em(xyc, m, n, make_kernel_params(pm))
    _assert_em_close(got, want, len(pairs))


@pytest.mark.parametrize("which", MODELS)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_em_plain_matches_pallas_interpret(name, which):
    make, seed = FIXTURES[name]
    pairs = make(np.random.default_rng(seed))
    jm, pm = _models(which)
    # one diagonal count for every fixture: one interpret-mode compile
    batch = prepare_banded_batch(pairs, band_width=W, k_max=40)
    want = ppr.PallasRealignPlan(batch, jax_params(jm)).run(interpret=True)
    xyc, m, n = _xyc(pairs, batch.k_max)
    got = realign_em(xyc, m, n, make_kernel_params(pm))
    _assert_em_close(got, want, len(pairs))


def test_em_counts_are_consistent():
    """Per read: every state's emission counts and the transitions out
    of every cell sum to what the lattice holds (m + n - matches
    cells emit; each count is non-negative)."""
    pairs = mixed_pairs(np.random.default_rng(17))
    xyc, m, n = _xyc(pairs)
    out = realign_em(xyc, m, n, make_kernel_params(PairHmmModel.default()))
    assert (out["trans"] >= 0).all() and (out["emis"] >= 0).all()
    emis = out["emis"].numpy().astype(np.float64)
    match = emis[:, 0].sum(axis=1)
    dele = emis[:, 1].sum(axis=1) + emis[:, 3].sum(axis=1)
    ins = emis[:, 2].sum(axis=1) + emis[:, 4].sum(axis=1)
    # a path's matches + deletions consume the window, matches +
    # insertions the read; expectations inherit both identities
    np.testing.assert_allclose(match + dele, n.numpy(), rtol=1e-4)
    np.testing.assert_allclose(match + ins, m.numpy(), rtol=1e-4)
    # one transition into every emitting cell
    np.testing.assert_allclose(
        out["trans"].numpy().astype(np.float64).sum(axis=(1, 2)),
        match + dele + ins, rtol=1e-4)


def test_em_wrapper_routes_cpu_tensors_to_plain():
    pairs = mixed_pairs(np.random.default_rng(17))
    xyc, m, n = _xyc(pairs)
    params = make_kernel_params(PairHmmModel.default())
    before = port_realign.EM_LAUNCHES.count
    a = realign_em(xyc, m, n, params)
    b = realign_em_plain(xyc, m, n, params)
    for key in ("loglik", "trans", "emis"):
        assert torch.equal(a[key], b[key])
    assert a["trans"].shape == (3, 5, 5) and a["emis"].shape == (3, 5, 16)
    # the plain version is no kernel launch
    assert port_realign.EM_LAUNCHES.count == before
    with pytest.raises(ValueError):
        realign_em(xyc, m.to(torch.int64), n, params)
    with pytest.raises(ValueError):
        realign_em(xyc.to(torch.int32), m, n, params)
    # W = 6, no power of two: the plain version lays the codes into 8
    # lanes, the two new ones dead, and gives that layout's sums
    narrow = xyc[:, :, :6].contiguous()
    padded = realign_em(pad_lanes(narrow, 8), m, n, params, band_width=6)
    got = realign_em(narrow, m, n, params)
    for key in ("loglik", "trans", "emis"):
        assert torch.equal(got[key], padded[key])


def test_em_padding_diagonals_do_not_change_results():
    """A read's sums do not depend on the batch's diagonal count."""
    pairs = mixed_pairs(np.random.default_rng(17))
    params = make_kernel_params(PairHmmModel.default())
    short = realign_em(*_xyc(pairs), params)
    long_ = realign_em(*_xyc(pairs, 300), params)
    for key in ("loglik", "trans", "emis"):
        assert torch.equal(short[key], long_[key])


def test_em_results_do_not_depend_on_the_batch():
    """A read alone gives the sums it gives inside a batch (so the EM
    batch size does not change the trained model)."""
    pairs = mixed_pairs(np.random.default_rng(17))
    params = make_kernel_params(PairHmmModel.default())
    whole = realign_em(*_xyc(pairs), params)
    for b, pair in enumerate(pairs):
        one = realign_em(*_xyc([pair]), params)
        for key in ("loglik", "trans", "emis"):
            assert torch.equal(one[key][0], whole[key][b])


def test_prepared_em_reruns_on_resident_codes():
    """``PreparedEm.run(params)`` serves every model from one pack."""
    pairs = mixed_pairs(np.random.default_rng(17))
    prep = prepared_from_pairs({"device": "cpu"}, pairs, None,
                               band_width=W, prepared_cls=PreparedEm)
    assert isinstance(prep, PreparedEm)
    xyc_id = prep.xyc.data_ptr()
    for which in MODELS:
        jm, pm = _models(which)
        batch = prepare_banded_batch(pairs, band_width=W)
        want = em_expectations(batch, jax_params(jm), segment_size=8)
        _assert_em_close(prep.run(make_kernel_params(pm)), want, len(pairs))
    assert prep.xyc.data_ptr() == xyc_id


@pytest.mark.parametrize("which", MODELS)
def test_em_short_read_beside_one_five_times_longer(which):
    """A read's loglik, trans and emis are bit-identical beside a read
    five times longer and alone (the far-end ratio of the EM batch)."""
    pairs = _far_end_pairs(3)
    params = make_kernel_params(_models(which)[1])
    both = realign_em(*_xyc(pairs), params)
    alone = realign_em(*_xyc(pairs[:1]), params)
    for key in ("loglik", "trans", "emis"):
        assert torch.equal(both[key][0], alone[key][0])
