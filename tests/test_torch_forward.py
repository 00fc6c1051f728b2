"""Port's plain forward-only log-likelihood vs the JAX package.

* ``pallas_forward_loglik`` (the JAX forward-only Pallas kernel, in
  interpret mode) on the uniform-band batches of tests/test_pallas.py:
  plain reads, N bases, and a lattice spanning several of its chunks:
  rtol 1e-5;
* ``ops.pairhmm.forward_loglik`` (the XLA scan, which rescales every
  diagonal) on a batch of mixed band geometry, which the JAX kernel
  refuses and the port's serves: rtol 1e-5;
* the realign kernel's decode-mode loglik (the same quantity, with a
  Kahan-compensated log-scale): rtol 1e-5;
* the Viterbi score, the best single path, is at most the forward
  log-likelihood of every read (tests/test_viterbi.py's bar).
"""

import numpy as np
import pytest
import torch

import nanopore_tpu.ops.pairhmm_pallas as pallas_fwd
from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.io.sam import CIG
from nanopore_tpu.ops.pairhmm import forward_loglik as jax_forward_loglik
from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.ops import dispatch
from nanopore_tpu_torch.ops.forward import forward_loglik, forward_loglik_plain
from nanopore_tpu_torch.ops.pack import pack_stream_pairs, pack_xyc
from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
from nanopore_tpu_torch.ops.realign import realign_decode_plain
from nanopore_tpu_torch.ops.viterbi import viterbi_forward_plain

from test_pallas import uniform_pairs
from test_torch_viterbi import mixed_pairs


def _uniform(rng, B, L):
    return uniform_pairs(rng, B, L)


def _n_bases(rng):
    pairs = uniform_pairs(rng, 2, 30)
    pairs[0][0][3] = 4  # N in ref
    pairs[1][1][7] = 4  # N in read
    return pairs


# (pairs, band width, the JAX kernel's CHUNK): tests/test_pallas.py's
UNIFORM = {
    "plain": (lambda: _uniform(np.random.default_rng(0), 4, 40), 16, None),
    "n_bases": (lambda: _n_bases(np.random.default_rng(1)), 16, None),
    "multi_chunk": (lambda: _uniform(np.random.default_rng(2), 2, 60), 16,
                    32),
}


def _port(pairs, W, K=None):
    prep = pack_stream_pairs(pairs, W, K)
    t = torch.from_numpy
    m, n = t(prep["m"]), t(prep["n"])
    xyc = pack_xyc(t(prep["stream"]), t(prep["initx"]), m, n)
    return xyc, m, n


def _params():
    return make_kernel_params(PairHmmModel.default())


@pytest.mark.parametrize("name", sorted(UNIFORM))
def test_plain_matches_pallas_forward_interpret(name):
    make, W, chunk = UNIFORM[name]
    pairs = make()
    batch = prepare_banded_batch(pairs, band_width=W)
    old = pallas_fwd.CHUNK
    if chunk:
        pallas_fwd.CHUNK = chunk
    try:
        want = np.asarray(pallas_fwd.pallas_forward_loglik(
            batch, jax_params(JaxModel.default()), interpret=True))
    finally:
        pallas_fwd.CHUNK = old
        pallas_fwd._pallas_forward_call.clear_cache()
    got = forward_loglik_plain(*_port(pairs, W, batch.k_max), _params())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.fixture(scope="module")
def mixed():
    """A batch of mixed band geometry (match, delete, insert guides, N
    bases, a longer read) at W = 8: the JAX kernel refuses it."""
    pairs = mixed_pairs(np.random.default_rng(41))
    batch = prepare_banded_batch(pairs, band_width=8)
    xyc, m, n = _port(pairs, 8, batch.k_max)
    return {"pairs": pairs, "batch": batch, "xyc": xyc, "m": m, "n": n,
            "loglik": forward_loglik_plain(xyc, m, n, _params())}


def test_plain_matches_xla_forward_on_mixed_geometry(mixed):
    with pytest.raises(ValueError):
        pallas_fwd.pallas_forward_loglik(
            mixed["batch"], jax_params(JaxModel.default()), interpret=True)
    want = np.asarray(jax_forward_loglik(mixed["batch"],
                                         jax_params(JaxModel.default())))
    np.testing.assert_allclose(mixed["loglik"].numpy(), want, rtol=1e-5)


def test_plain_matches_the_realign_decode_loglik(mixed):
    out = realign_decode_plain(mixed["xyc"], mixed["m"], mixed["n"],
                               _params())
    np.testing.assert_allclose(mixed["loglik"].numpy(),
                               out["loglik"].numpy(), rtol=1e-5)


def test_viterbi_score_below_forward(mixed):
    vit = viterbi_forward_plain(mixed["xyc"], mixed["m"], mixed["n"],
                                _params())["score"]
    ll = mixed["loglik"]
    assert torch.isfinite(vit).all() and torch.isfinite(ll).all()
    assert (vit <= ll + 1e-5 * ll.abs()).all()


def test_prepared_forward_and_wrapper(mixed):
    prep = dispatch.prepared_from_pairs(
        {"device": "cpu"}, mixed["pairs"], _params(), band_width=8,
        prepared_cls=dispatch.PreparedForward)
    assert torch.equal(prep.run(), mixed["loglik"])
    assert torch.equal(forward_loglik(mixed["xyc"], mixed["m"], mixed["n"],
                                      _params()), mixed["loglik"])
    with pytest.raises(ValueError):
        forward_loglik(mixed["xyc"], mixed["m"], mixed["n"].long(), _params())


def test_padding_diagonals_do_not_change_the_loglik(mixed):
    long_ = forward_loglik_plain(*_port(mixed["pairs"], 8, 300), _params())
    assert torch.equal(long_, mixed["loglik"])
