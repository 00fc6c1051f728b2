"""Port's kernel tables and band geometry vs the JAX package."""

import numpy as np
import pytest
import torch

from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.io.sam import CIG
from nanopore_tpu.ops.pairhmm import band_offsets_from_cigar as jax_offsets
from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
from nanopore_tpu_torch.align.model import PairHmmModel, model_from_numpy
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


# ---- the model itself: the state EM trains and every stage loads ----

def _same_model(a, b):
    np.testing.assert_array_equal(a.transitions, b.transitions)
    np.testing.assert_array_equal(a.emissions, b.emissions)
    assert a.likelihood == b.likelihood and a.model_type == b.model_type


MODEL_OPS = {
    "random": lambda m: None,
    "set_indel_emissions_flat": lambda m: m.set_indel_emissions_flat(),
    "normalise_by_reference_gc_content":
        lambda m: m.normalise_by_reference_gc_content(0.35),
    "modify_emissions_by_expected_variation_rate":
        lambda m: m.modify_emissions_by_expected_variation_rate(0.2),
}


@pytest.mark.parametrize("op", sorted(MODEL_OPS))
def test_model_methods_equal_the_jax_copy(op, tmp_path):
    """Same draws of one numpy stream, same method, byte-identical files."""
    jm = JaxModel.random(np.random.default_rng(11))
    pm = PairHmmModel.random(np.random.default_rng(11))
    MODEL_OPS[op](jm)
    MODEL_OPS[op](pm)
    _same_model(pm, jm)
    jm.write(str(tmp_path / "j.txt"))
    pm.write(str(tmp_path / "p.txt"))
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "p.txt").read_bytes()
    _same_model(PairHmmModel.load(str(tmp_path / "j.txt")),
                JaxModel.load(str(tmp_path / "p.txt")))
    jm.running_likelihoods = pm.running_likelihoods = [[-3.0, -2.5], [-4.0]]
    jm.write_xml(str(tmp_path / "j.xml"), jm.transitions / 7, jm.emissions / 3)
    pm.write_xml(str(tmp_path / "p.xml"), pm.transitions / 7, pm.emissions / 3)
    assert (tmp_path / "j.xml").read_bytes() == (tmp_path / "p.xml").read_bytes()


def test_model_crosses_between_the_packages():
    jm = JaxModel.random(np.random.default_rng(3))
    jm.likelihood = -12.5
    pm = model_from_numpy(jm.transitions, jm.emissions, jm.likelihood,
                          jm.model_type)
    _same_model(pm, jm)
    assert pm.transitions is not jm.transitions  # a copy, not a view
    back = JaxModel(transitions=np.array(pm.transitions),
                    emissions=np.array(pm.emissions),
                    likelihood=pm.likelihood, model_type=pm.model_type)
    want, got = jax_params(back), make_kernel_params(pm)
    for field in ("t", "e_match_flat", "e_gap_flat"):
        np.testing.assert_array_equal(np.asarray(getattr(want, field)),
                                      getattr(got, field).numpy())
    with pytest.raises(ValueError):
        model_from_numpy(jm.transitions[:4], jm.emissions)


def test_trained_models_ship_with_the_port():
    from nanopore_tpu.mapping.runner import trained_model_path as jax_path
    from nanopore_tpu_torch.mapping.runner import trained_model_path

    for name in ("blasr_hmm_0.txt", "blasr_hmm_20.txt", "blasr_hmm_40.txt"):
        path = trained_model_path(name)
        assert "nanopore_tpu_torch" in path
        _same_model(PairHmmModel.load(path), JaxModel.load(jax_path(name)))
