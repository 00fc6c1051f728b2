"""Port's kernel tables and band geometry vs the JAX package."""

import numpy as np
import pytest
import torch

from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.io.sam import CIG
from nanopore_tpu.ops.pairhmm import band_offsets_from_cigar as jax_offsets
from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.ops.pairhmm import (
    band_offsets_from_cigar,
    kernel_tables,
    make_kernel_params,
    params_from_numpy,
)

# the geometries of tests/test_pack_pallas.py::_guide_pairs
GUIDES = [
    [(CIG.M, 60)],
    [(CIG.M, 20), (CIG.D, 10), (CIG.M, 25)],
    [(CIG.M, 25), (CIG.I, 12), (CIG.M, 25)],
    [(CIG.I, 5), (CIG.M, 40), (CIG.D, 7), (CIG.M, 10)],
    [(CIG.D, 9), (CIG.M, 30), (CIG.I, 3)],
    [(CIG.M, 4)],
]


def _lengths(cig):
    n = sum(ln for op, ln in cig if op in (CIG.M, CIG.D))
    m = sum(ln for op, ln in cig if op in (CIG.M, CIG.I))
    return m, n


def test_params_from_numpy_equals_port_tables():
    want = jax_params(JaxModel.default())
    got = params_from_numpy(
        np.asarray(want.t), np.asarray(want.e_match_flat),
        np.asarray(want.e_gap_flat),
    )
    mine = make_kernel_params(PairHmmModel.default())
    for field in ("t", "e_match_flat", "e_gap_flat"):
        a, b = getattr(got, field), getattr(mine, field)
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b), field


def test_kernel_tables_pad_sentinel_with_zeros():
    tab = kernel_tables(make_kernel_params(PairHmmModel.default()))
    assert tab.shape == (91,)
    emf = tab[25:61].reshape(6, 6)
    egf = tab[61:91].reshape(5, 6)
    assert (emf[5] == 0).all() and (emf[:, 5] == 0).all()
    assert (egf[:, 5] == 0).all()


@pytest.mark.parametrize("W", [8, 32, 64])
@pytest.mark.parametrize("k_extra", [0, 70])
def test_band_offsets_identical(W, k_extra):
    for cig in GUIDES:
        m, n = _lengths(cig)
        k_max = m + n + k_extra
        np.testing.assert_array_equal(
            band_offsets_from_cigar(cig, m, n, W, k_max),
            jax_offsets(cig, m, n, W, k_max),
        )
