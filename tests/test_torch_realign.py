"""Port's plain decode-mode realign vs the JAX package.

Two references on the fixtures of tests/test_pallas_realign.py (uniform
reads, N bases with an indel guide, mixed band geometry), at W = 8:

* ``nanopore_tpu.ops.mea.realign_fused`` (the XLA scan): loglik rtol
  1e-5, score rtol/atol 1e-4 (the XLA scan rescales every diagonal, the
  port every 2nd one; that changes f32 rounding only) and identical
  cigars;
* the Pallas kernel in interpret mode with its CHUNK/SEG patched small
  as that file does: loglik rtol 1e-4 and identical cigars.
"""

import numpy as np
import pytest
import torch

import nanopore_tpu.ops.pairhmm_pallas_realign as ppr
from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.io.sam import CIG
from nanopore_tpu.ops.mea import mea_traceback_fwd, realign_fused
from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.ops.pack import pack_stream_pairs, pack_xyc
from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
from nanopore_tpu_torch.ops.realign import (
    realign_decode,
    realign_decode_plain,
    untile,
)
from nanopore_tpu_torch.ops.traceback import mea_walk, rle_ops_batch

W = 8


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


def n_base_pairs(rng):
    L = 16
    pairs = []
    for _ in range(2):
        x = rng.integers(0, 4, L).astype(np.int8)
        y = x[: L - 4].copy()
        y[5] = 4  # N in read
        pairs.append((x, y, [(CIG.M, L - 4), (CIG.D, 4)]))
    pairs[0][0][3] = 4  # N in ref
    return pairs


def mixed_pairs(rng):
    x0 = rng.integers(0, 4, 18).astype(np.int8)
    x1 = rng.integers(0, 4, 16).astype(np.int8)
    x2 = rng.integers(0, 4, 10).astype(np.int8)
    y2 = np.concatenate([x2[:5], rng.integers(0, 4, 6).astype(np.int8),
                         x2[5:]])
    return [
        (x0, x0.copy(), [(CIG.M, 18)]),
        (x1, x1[:10].copy(), [(CIG.M, 5), (CIG.D, 6), (CIG.M, 5)]),
        (x2, y2, [(CIG.M, 5), (CIG.I, 6), (CIG.M, 5)]),
    ]


FIXTURES = {
    "uniform": (uniform_pairs, 7),
    "n_bases_indel_guide": (n_base_pairs, 11),
    "mixed_band_geometry": (mixed_pairs, 17),
}


def _port(pairs, K):
    prep = pack_stream_pairs(pairs, W, K)
    t = torch.from_numpy
    m, n = t(prep["m"]), t(prep["n"])
    xyc = pack_xyc(t(prep["stream"]), t(prep["initx"]), m, n)
    out = realign_decode(xyc, m, n, make_kernel_params(PairHmmModel.default()))
    cigars = rle_ops_batch(mea_walk(out["dirs"], xyc, m, n).numpy())
    return out, cigars, prep


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_plain_matches_xla_realign_fused(name):
    make, seed = FIXTURES[name]
    pairs = make(np.random.default_rng(seed))
    batch = prepare_banded_batch(pairs, band_width=W)
    want = realign_fused(batch, jax_params(JaxModel.default()),
                         segment_size=8)
    got, cigars, prep = _port(pairs, batch.k_max)
    np.testing.assert_allclose(got["loglik"].numpy(),
                               np.asarray(want["loglik"]), rtol=1e-5)
    np.testing.assert_allclose(got["score"].numpy(),
                               np.asarray(want["score"]), rtol=1e-4,
                               atol=1e-4)
    offsets = np.asarray(batch.offsets)
    want_dirs = np.asarray(want["dirs"])
    got_dirs = got["dirs"].numpy()
    for b, (x, y, _) in enumerate(pairs):
        m, n = len(y), len(x)
        want_cig = mea_traceback_fwd(want_dirs[b], offsets[b], m, n)
        assert mea_traceback_fwd(got_dirs[b], prep["offsets"][b], m, n) \
            == want_cig
        assert cigars[b] == want_cig


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_plain_matches_pallas_interpret(name):
    make, seed = FIXTURES[name]
    pairs = make(np.random.default_rng(seed))
    batch = prepare_banded_batch(pairs, band_width=W)
    plan = ppr.PallasRealignPlan(batch, jax_params(JaxModel.default()),
                                 emit_em=False)
    want = plan.run(interpret=True)
    got, cigars, _ = _port(pairs, batch.k_max)
    np.testing.assert_allclose(got["loglik"].numpy(),
                               np.asarray(want["loglik"]), rtol=1e-4)
    np.testing.assert_allclose(got["score"].numpy(),
                               np.asarray(want["score"]), rtol=1e-4,
                               atol=1e-4)
    bands = untile(want["dirs_raw"], len(pairs))
    offsets = np.asarray(batch.offsets)
    for b, (x, y, _) in enumerate(pairs):
        assert cigars[b] == mea_traceback_fwd(bands[b], offsets[b], len(y),
                                              len(x))


def test_wrapper_routes_cpu_tensors_to_plain():
    pairs = mixed_pairs(np.random.default_rng(17))
    prep = pack_stream_pairs(pairs, W)
    t = torch.from_numpy
    m, n = t(prep["m"]), t(prep["n"])
    xyc = pack_xyc(t(prep["stream"]), t(prep["initx"]), m, n)
    params = make_kernel_params(PairHmmModel.default())
    a = realign_decode(xyc, m, n, params)
    b = realign_decode_plain(xyc, m, n, params)
    for key in ("loglik", "score", "dirs"):
        assert torch.equal(a[key], b[key])
    with pytest.raises(ValueError):
        realign_decode(xyc, m.to(torch.int64), n, params)


def test_padding_diagonals_do_not_change_results():
    """A read's outputs do not depend on the batch's diagonal count."""
    pairs = mixed_pairs(np.random.default_rng(17))
    short, _, _ = _port(pairs, None)
    long_, _, _ = _port(pairs, 300)
    assert torch.equal(short["loglik"], long_["loglik"])
    assert torch.equal(short["score"], long_["score"])
    K1 = short["dirs"].shape[1]
    assert torch.equal(short["dirs"], long_["dirs"][:, :K1])
