"""The port's EM flank corridor vs the JAX package.

The port computes the pure-deletion corridor only in its native library
(no NumPy twin on its path).  The NumPy forward/backward below is the
oracle, kept here for the tests alone; it is held against the JAX
package's ``align.flank`` as well, so the three agree:

* native ``flank_corridor`` vs the oracle and vs the JAX package:
  counts atol 1e-12, logz 1e-9;
* ``em_flank_correction`` and ``corridor_tables`` equal to the JAX
  package's to 1e-12.

No case depends on what either wrapper returns when the corridor mass
underflows.
"""

import numpy as np
import pytest

from nanopore_tpu.align import flank as jax_flank
from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.io.sam import CIG
from nanopore_tpu_torch.align import flank
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.runtime.native_index import flank_corridor

_D = np.array([1, 3], np.int64)  # short delete, long delete
START = np.full(5, 0.2)
ONES = np.ones(5)
ENTRIES = {"start": START, "ones": ONES}


def corridor_expectations_np(x, t, eg, entry):
    """Forward/backward over the two delete states with per-step
    normalisation: (trans (5,5), emis (5,16), logz)."""
    F = len(x)
    trans = np.zeros((5, 5))
    emis = np.zeros((5, 16))
    entry = np.asarray(entry, np.float64)
    if F == 0:
        return trans, emis, float(np.log(max(entry[_D].sum(), 1e-300)))
    tD = t[:, _D]
    tDD = t[np.ix_(_D, _D)]
    egD = eg[_D]
    xs = np.asarray(x, np.int64)
    f = np.empty((F + 1, 2))
    s0 = entry.sum()
    logz = np.log(max(s0, 1e-300))
    e0 = entry / max(s0, 1e-300)
    raw = (e0 @ tD) * egD[:, xs[0]]
    for k in range(1, F + 1):
        if k > 1:
            raw = (f[k - 1] @ tDD) * egD[:, xs[k - 1]]
        sk = raw.sum()
        f[k] = raw / sk
        logz += np.log(sk)
    logz += np.log(max(f[F].sum(), 1e-300))
    b = np.ones(2)
    for k in range(F, 0, -1):
        xb = xs[k - 1]
        occ = f[k] * b
        if xb < 4:
            emis[_D, xb * 4:xb * 4 + 4] += (occ / occ.sum() / 4.0)[:, None]
        if k == 1:
            w = e0[:, None] * (tD * (egD[:, xb] * b)[None, :])
            trans[:, _D] += w / w.sum()
            break
        w = f[k - 1][:, None] * (tDD * (egD[:, xb] * b)[None, :])
        trans[np.ix_(_D, _D)] += w / w.sum()
        braw = (tDD * egD[:, xb][None, :]) @ b
        b = braw / braw.sum()
    return trans, emis, float(logz)


def _models(seed):
    return (JaxModel.random(np.random.default_rng(seed)),
            PairHmmModel.random(np.random.default_rng(seed)))


def test_corridor_tables_equal():
    jm, pm = _models(1)
    for a, b in zip(jax_flank.corridor_tables(jm), flank.corridor_tables(pm)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("F", [0, 1, 5, 333, 4000])
def test_native_corridor_matches_oracle_and_jax(F, entry):
    rng = np.random.default_rng(100 + F)
    jm, pm = _models(1)
    t, eg = flank.corridor_tables(pm)
    x = rng.integers(0, 5, F).astype(np.int8)  # N bases included
    got = flank_corridor(x, t, eg, ENTRIES[entry])
    assert got[0].shape == (5, 5) and got[1].shape == (5, 16)
    for want in (
        corridor_expectations_np(x, t, eg, ENTRIES[entry]),
        jax_flank.corridor_expectations(
            x, *jax_flank.corridor_tables(jm), ENTRIES[entry]),
    ):
        np.testing.assert_allclose(got[0], want[0], atol=1e-12)
        np.testing.assert_allclose(got[1], want[1], atol=1e-12)
        assert abs(got[2] - want[2]) < 1e-9


def test_corridor_counts_one_transition_and_emission_per_base():
    _, pm = _models(3)
    t, eg = flank.corridor_tables(pm)
    x = np.random.default_rng(4).integers(0, 4, 200).astype(np.int8)
    trans, emis, logz = flank_corridor(x, t, eg, START)
    assert np.isfinite(logz)
    np.testing.assert_allclose(trans.sum(), 200, rtol=1e-12)
    np.testing.assert_allclose(emis.sum(), 200, rtol=1e-12)
    assert trans[:, [0, 2, 4]].sum() == 0  # only into the delete states


def test_flank_lengths_equal():
    for cig in ([(CIG.D, 10), (CIG.M, 5), (CIG.I, 2), (CIG.D, 7)],
                [(CIG.M, 5)], [(CIG.D, 9)],
                [(CIG.N, 3), (CIG.D, 2), (CIG.M, 1)],
                # a read-end insert after the reference's remainder: no
                # trailing deletion run in either package
                [(CIG.D, 400), (CIG.M, 150), (CIG.D, 900), (CIG.I, 2)]):
        assert flank.flank_lengths(cig) == jax_flank.flank_lengths(cig)
    assert flank.flank_lengths(
        [(CIG.D, 400), (CIG.M, 150), (CIG.D, 900), (CIG.I, 2)]) == (400, 0)


@pytest.mark.parametrize("pad", [16, 64, 256])
@pytest.mark.parametrize("lead,tail", [(400, 900), (0, 700), (1200, 0),
                                       (10, 20)])
def test_em_flank_correction_equals_jax(lead, tail, pad):
    rng = np.random.default_rng(lead + tail + pad)
    jm, pm = _models(7)
    mlen = 150
    x = rng.integers(0, 4, lead + mlen + tail).astype(np.int8)
    guide = [(CIG.D, lead)] * (lead > 0) + [(CIG.M, mlen)] \
        + [(CIG.D, tail)] * (tail > 0)
    want = jax_flank.em_flank_correction(
        x, guide, pad, *jax_flank.corridor_tables(jm))
    got = flank.em_flank_correction(x, guide, pad, *flank.corridor_tables(pm))
    np.testing.assert_allclose(got[0], want[0], atol=1e-12)
    np.testing.assert_allclose(got[1], want[1], atol=1e-12)
    assert abs(got[2] - want[2]) < 1e-12 * max(1.0, abs(want[2]))
    if lead <= pad and tail <= pad:  # the window is the whole reference
        assert not got[0].any() and not got[1].any() and got[2] == 0.0
    # with the read's last bases after the reference's remainder the
    # guide has no tail: only the lead is corrected, in both packages
    guide = guide + [(CIG.I, 2)]
    want = jax_flank.em_flank_correction(
        x, guide, pad, *jax_flank.corridor_tables(jm))
    got = flank.em_flank_correction(x, guide, pad, *flank.corridor_tables(pm))
    np.testing.assert_allclose(got[0], want[0], atol=1e-12)
    np.testing.assert_allclose(got[1], want[1], atol=1e-12)
    assert abs(got[2] - want[2]) < 1e-12 * max(1.0, abs(want[2]))
