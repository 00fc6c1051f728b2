"""Port's stream pack and plain band pack vs the JAX package.

The plain pack must write the same bytes as the JAX packer kernel
(``materialize_xyc``, interpret mode) and the JAX host pack, once the
JAX package's lane tiling is undone.
"""

import numpy as np
import pytest
import torch

from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.io.sam import CIG
from nanopore_tpu.ops.pack_pallas import materialize_xyc
from nanopore_tpu.ops.pack_pallas import pack_stream_pairs as jax_stream
from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
from nanopore_tpu.ops.pairhmm_pallas_realign import pack_pallas_pairs
from nanopore_tpu_torch.ops.pack import pack_stream_pairs, pack_xyc
from nanopore_tpu_torch.ops.realign import untile


def _guide_pairs(rng):
    """The mixed geometries of tests/test_pack_pallas.py: pure match,
    deletions, insertions, leading indels, N bases, very short reads."""
    pairs = []
    for cig in [
        [(CIG.M, 60)],
        [(CIG.M, 20), (CIG.D, 10), (CIG.M, 25)],
        [(CIG.M, 25), (CIG.I, 12), (CIG.M, 25)],
        [(CIG.I, 5), (CIG.M, 40), (CIG.D, 7), (CIG.M, 10)],
        [(CIG.D, 9), (CIG.M, 30), (CIG.I, 3)],
        [(CIG.M, 4)],
    ]:
        n = sum(ln for op, ln in cig if op in (CIG.M, CIG.D))
        m = sum(ln for op, ln in cig if op in (CIG.M, CIG.I))
        x = rng.integers(0, 4, n).astype(np.int8)
        y = rng.integers(0, 5, m).astype(np.int8)  # incl. N codes
        pairs.append((x, y, cig))
    return pairs


@pytest.fixture(scope="module")
def jparams():
    return jax_params(JaxModel.default())


def _port_xyc(prep):
    t = torch.from_numpy
    return pack_xyc(
        t(prep["stream"]), t(prep["initx"]), t(prep["m"]), t(prep["n"])
    ).numpy()


@pytest.mark.parametrize("W", [32, 64])
def test_host_stream_matches_jax(jparams, W):
    pairs = _guide_pairs(np.random.default_rng(7))
    want = jax_stream(pairs, jparams, band_width=W)
    got = pack_stream_pairs(pairs, band_width=W)
    B = len(pairs)
    assert (got["k_pad"], got["K"], got["B"], got["W"]) == (
        want["k_pad"], want["K"], want["B"], want["W"]
    )
    np.testing.assert_array_equal(
        got["stream"], untile(want["stream"], B).reshape(B, -1).view(np.uint8)
    )
    np.testing.assert_array_equal(
        got["initx"], untile(want["initx"], B).view(np.uint8)
    )
    np.testing.assert_array_equal(got["offsets"], want["offsets"])
    np.testing.assert_array_equal(got["m"], want["m"])
    np.testing.assert_array_equal(got["n"], want["n"])
    np.testing.assert_array_equal(got["k_end"], want["k_end"])


@pytest.mark.parametrize("W", [32, 64])
def test_plain_pack_matches_jax_kernel_and_host_pack(jparams, W):
    pairs = _guide_pairs(np.random.default_rng(7))
    B = len(pairs)
    got = _port_xyc(pack_stream_pairs(pairs, band_width=W))
    kernel = materialize_xyc(jax_stream(pairs, jparams, band_width=W),
                             interpret=True)
    np.testing.assert_array_equal(got, untile(kernel["xyc"], B))
    host = pack_pallas_pairs(pairs, jparams, band_width=W)
    np.testing.assert_array_equal(got, untile(host["xyc"], B))


def test_tight_kmax_multi_chunk(jparams):
    """k_pad over several 128-diagonal chunks and an explicit k_max."""
    rng = np.random.default_rng(11)
    n = 200
    x = rng.integers(0, 4, n).astype(np.int8)
    y = x.copy()
    y[rng.integers(0, n, 30)] = rng.integers(0, 4, 30)
    pairs = [
        (x, y, [(CIG.M, n)]),
        (x[:150], y[:120], [(CIG.M, 100), (CIG.D, 50), (CIG.I, 20)]),
    ]
    got = _port_xyc(pack_stream_pairs(pairs, 64, k_max=512))
    want = pack_pallas_pairs(pairs, jparams, 64, k_max=512)
    np.testing.assert_array_equal(got, untile(want["xyc"], len(pairs)))


def test_kernel_wrapper_checks_inputs():
    prep = pack_stream_pairs(_guide_pairs(np.random.default_rng(3)), 32)
    t = torch.from_numpy
    with pytest.raises(TypeError):
        pack_xyc(t(prep["stream"]).to(torch.int32), t(prep["initx"]),
                 t(prep["m"]), t(prep["n"]))
    with pytest.raises(ValueError):
        pack_xyc(t(prep["stream"]), t(prep["initx"]), t(prep["m"][:2]),
                 t(prep["n"]))
