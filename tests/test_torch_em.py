"""The port's Baum-Welch EM (``align.em``) vs the JAX package's.

Both packages train on the same pairs (seeded numpy), from the same
``PairHmmModel.random`` draws (one ``np.random.default_rng(seed)`` stream
each), with ``EmOptions(trials=2, iterations=3)`` at W = 32:

* every running likelihood rtol 1e-5, every trial's transitions and
  emissions atol 1e-4, with the window + analytic flank correction
  (``window_pad=32``) and without (``window_pad=None``).  Windowed is
  held against the JAX package's windowed run, not against the full
  lattice: the JAX package's own windowed-vs-full test misses its 1e-4
  bar on this tree;
* a run killed mid-trial and resumed from its checkpoint gives the
  uninterrupted run's model, and a checkpoint written by either package
  resumes in the other;
* ``_m_step`` and the three files of ``learn_model_from_sam_file``
  (``hmm.txt``, ``hmm.txt_unnormalised``, ``hmm.txt.xml``) agree field
  by field within 1e-4;
* a chained record that ends ``<tail>D <k>I`` windows to the end of the
  reference in both packages, and the scaled f32 recursion cannot hold
  its expectations in either; the port's ``em_train`` leaves such a read
  out of the counts (``representable``), which the JAX package does not.

The JAX side runs its XLA scan (``em_expectations``) on the CPU; the
port its plain PyTorch version (``device="cpu"``).  Per-read sums do not
depend on the batch, so the port takes all reads in one batch.
"""

import xml.etree.ElementTree as ET

import numpy as np
import pytest

from nanopore_tpu.align import em as jax_em
from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.io.encoding import decode
from nanopore_tpu.io.sam import CIG, SamRecord, SamWriter
from nanopore_tpu_torch.align import em as port_em
from nanopore_tpu_torch.align.model import PairHmmModel

W = 32
N_REF = 700
OPTS = dict(trials=2, iterations=3, band_width=W, seed=3)


def _global_pairs(seed=5, count=5):
    """Chained-style global pairs on one reference: lead and tail
    deletions around a noisy 120-180 base read."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, N_REF).astype(np.int8)
    pairs = []
    for _ in range(count):
        mlen = int(rng.integers(120, 180))
        lead = int(rng.integers(60, N_REF - mlen - 60))
        y = x[lead:lead + mlen].copy()
        idx = rng.integers(0, mlen, mlen // 10)
        y[idx] = (y[idx] + 1) % 4
        y = np.concatenate([y[:40], y[43:]])  # a 3-base deletion
        guide = [(CIG.D, lead), (CIG.M, 40), (CIG.D, 3),
                 (CIG.M, mlen - 43), (CIG.D, N_REF - lead - mlen)]
        pairs.append((x, y, guide))
    return pairs


def _assert_results_close(got, want):
    assert len(got.running_likelihoods) == len(want.running_likelihoods)
    for g, w in zip(got.running_likelihoods, want.running_likelihoods):
        assert len(g) == len(w)
        np.testing.assert_allclose(g, w, rtol=1e-5)
    for g, w in zip(got.trial_models, want.trial_models):
        np.testing.assert_allclose(g.transitions, w.transitions, atol=1e-4)
        np.testing.assert_allclose(g.emissions, w.emissions, atol=1e-4)
    np.testing.assert_allclose(got.model.transitions, want.model.transitions,
                               atol=1e-4)
    np.testing.assert_allclose(got.model.emissions, want.model.emissions,
                               atol=1e-4)
    np.testing.assert_allclose(got.model.likelihood, want.model.likelihood,
                               rtol=1e-5)


@pytest.fixture(scope="module")
def pairs():
    return _global_pairs()


@pytest.fixture(scope="module")
def port_windowed(pairs):
    """The uninterrupted windowed run of the port (shared by the
    parity and the resume tests)."""
    return port_em.em_train(
        pairs, port_em.EmOptions(window_pad=32, batch_size=8, **OPTS),
        device="cpu")


@pytest.fixture(scope="module")
def jax_windowed(pairs):
    return jax_em.em_train(
        pairs, jax_em.EmOptions(window_pad=32, use_mesh=False, **OPTS))


def test_em_train_windowed_matches_jax(port_windowed, jax_windowed):
    _assert_results_close(port_windowed, jax_windowed)
    for trace in port_windowed.running_likelihoods:
        assert len(trace) == 3 and np.isfinite(trace).all()


def test_em_train_full_lattice_matches_jax(pairs):
    got = port_em.em_train(
        pairs[:3], port_em.EmOptions(window_pad=None, batch_size=8, **OPTS),
        device="cpu")
    want = jax_em.em_train(
        pairs[:3], jax_em.EmOptions(window_pad=None, use_mesh=False, **OPTS))
    _assert_results_close(got, want)


def test_em_train_stage_stats(pairs):
    from nanopore_tpu_torch.mapping.engine import StageStats

    stats = StageStats()
    opts = port_em.EmOptions(trials=1, iterations=2, band_width=W,
                             window_pad=32, batch_size=8)
    port_em.em_train(pairs[:2], opts, device="cpu", stats=stats)
    snap = stats.snapshot()
    for stage in ("em_e_step", "em_flank", "em_m_step"):
        assert snap[stage]["calls"] == 2
    assert "em_e_step_device" not in snap  # CUDA events: the card only


class _Killed(Exception):
    pass


def _kill_after(monkeypatch, module, calls):
    """Make ``module._m_step`` raise at its ``calls + 1``-th call."""
    real = module._m_step
    count = [0]

    def m_step(*args, **kwargs):
        count[0] += 1
        if count[0] > calls:
            raise _Killed()
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "_m_step", m_step)


def test_checkpoint_resume_gives_the_uninterrupted_model(
        pairs, port_windowed, tmp_path, monkeypatch):
    ck = str(tmp_path / "em.ckpt.npz")
    opts = port_em.EmOptions(window_pad=32, batch_size=8, checkpoint_path=ck,
                             checkpoint_every=1, **OPTS)
    with monkeypatch.context() as mp:
        _kill_after(mp, port_em, 4)  # dies in trial 1, iteration 1
        with pytest.raises(_Killed):
            port_em.em_train(pairs, opts, device="cpu")
    state = port_em.load_em_checkpoint(ck)
    assert (state["trial"], state["iteration"]) == (1, 1)
    resumed = port_em.em_train(pairs, opts, device="cpu")
    _assert_results_close(resumed, port_windowed)
    for g, w in zip(resumed.running_likelihoods,
                    port_windowed.running_likelihoods):
        assert g == w  # the same arithmetic on the same state
    assert not (tmp_path / "em.ckpt.npz").exists()  # removed when done


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(writer, pairs, port_windowed,
                                     jax_windowed, tmp_path, monkeypatch):
    ck = str(tmp_path / "em.ckpt.npz")
    kw = dict(window_pad=32, checkpoint_path=ck, checkpoint_every=1, **OPTS)
    popts = port_em.EmOptions(batch_size=8, **kw)
    jopts = jax_em.EmOptions(use_mesh=False, **kw)
    assert port_em.em_fingerprint(pairs, popts) == \
        jax_em.em_fingerprint(pairs, jopts)
    with monkeypatch.context() as mp:
        if writer == "jax":
            _kill_after(mp, jax_em, 5)  # dies in trial 1, iteration 2
            with pytest.raises(_Killed):
                jax_em.em_train(pairs, jopts)
        else:
            _kill_after(mp, port_em, 5)
            with pytest.raises(_Killed):
                port_em.em_train(pairs, popts, device="cpu")
    state = port_em.load_em_checkpoint(ck)
    assert (state["trial"], state["iteration"]) == (1, 2)
    if writer == "jax":
        resumed = port_em.em_train(pairs, popts, device="cpu")
    else:
        resumed = jax_em.em_train(pairs, jopts)
    _assert_results_close(resumed, port_windowed)
    _assert_results_close(resumed, jax_windowed)


def test_stale_checkpoint_is_ignored(pairs, tmp_path):
    ck = str(tmp_path / "em.ckpt.npz")
    opts = port_em.EmOptions(trials=1, iterations=1, band_width=W,
                             window_pad=32, batch_size=8, checkpoint_path=ck)
    fp = port_em.em_fingerprint(pairs[:2], opts)
    port_em.save_em_checkpoint(ck, {**fp, "seed": 99, "trial": 0,
                                    "iteration": 0})
    assert not port_em.checkpoint_matches(port_em.load_em_checkpoint(ck), fp)
    (tmp_path / "bad.npz").write_bytes(b"not a zip file")
    assert port_em.load_em_checkpoint(str(tmp_path / "bad.npz")) is None
    assert port_em.load_em_checkpoint(str(tmp_path / "none.npz")) is None


def test_m_step_equals_jax():
    rng = np.random.default_rng(9)
    jm = JaxModel.random(np.random.default_rng(2))
    pm = PairHmmModel.random(np.random.default_rng(2))
    trans = rng.random((5, 5)) * 100
    emis = rng.random((5, 16)) * 100
    want = jax_em._m_step(jm, trans, emis, 1e-6)
    got = port_em._m_step(pm, trans, emis, 1e-6)
    np.testing.assert_array_equal(got.transitions, want.transitions)
    np.testing.assert_array_equal(got.emissions, want.emissions)
    np.testing.assert_allclose(got.transitions.sum(axis=1), 1.0)
    # structural zeros of the model stay zero
    assert ((got.transitions == 0) == (pm.transitions == 0)).all()


def _write_chained_sam(path, fasta, pairs):
    fasta.write_text(">ref\n%s\n" % decode(pairs[0][0]))
    with SamWriter(str(path), {"ref": N_REF}) as w:
        for i, (_, y, guide) in enumerate(pairs):
            w.write(SamRecord(qname="q%d" % i, flag=0, rname="ref", pos=0,
                              mapq=60, cigar=guide, seq=decode(y)))


def _xml_numbers(path):
    root = ET.parse(path).getroot()
    rows = [("likelihood", [float(root.attrib["likelihood"])])]
    for el in root:
        if el.tag == "hmm":
            rows.append(("trace", [float(v) for v in
                                   el.attrib["runningLikelihoods"].split()]))
        else:
            key = tuple((k, v) for k, v in sorted(el.attrib.items())
                        if k not in ("avg", "std"))
            rows.append(((el.tag,) + key,
                         [float(el.attrib["avg"]), float(el.attrib["std"])]))
    return rows


def test_learn_model_from_sam_file_writes_the_jax_files(pairs, tmp_path):
    fasta = tmp_path / "ref.fa"
    sam = tmp_path / "chained.sam"
    _write_chained_sam(sam, fasta, pairs[:3])
    kw = dict(window_pad=32, **OPTS)
    want = jax_em.learn_model_from_sam_file(
        str(sam), str(fasta), str(tmp_path / "j.hmm"),
        jax_em.EmOptions(use_mesh=False, **kw))
    got = port_em.learn_model_from_sam_file(
        str(sam), str(fasta), str(tmp_path / "p.hmm"),
        port_em.EmOptions(batch_size=8, **kw), device="cpu")
    np.testing.assert_allclose(got.transitions, want.transitions, atol=1e-4)
    np.testing.assert_allclose(got.emissions, want.emissions, atol=1e-4)
    for suffix in ("", "_unnormalised"):
        a = PairHmmModel.load(str(tmp_path / ("p.hmm" + suffix)))
        b = PairHmmModel.load(str(tmp_path / ("j.hmm" + suffix)))
        np.testing.assert_allclose(a.transitions, b.transitions, atol=1e-4)
        np.testing.assert_allclose(a.emissions, b.emissions, atol=1e-4)
        np.testing.assert_allclose(a.likelihood, b.likelihood, rtol=1e-5)
        np.testing.assert_allclose(a.transitions.sum(axis=1), 1.0)
    # the normalised model has flat indel emissions
    np.testing.assert_allclose(got.emissions[1:], 1.0 / 16)
    px = _xml_numbers(str(tmp_path / "p.hmm.xml"))
    jx = _xml_numbers(str(tmp_path / "j.hmm.xml"))
    assert [k for k, _ in px] == [k for k, _ in jx]
    for (key, a), (_, b) in zip(px, jx):
        if key in ("likelihood", "trace"):
            np.testing.assert_allclose(a, b, rtol=1e-5)
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, err_msg=str(key))
    assert not (tmp_path / "p.hmm.ckpt.npz").exists()


def test_unported_em_options_raise(pairs):
    """The name is kept from when ``use_mesh=True`` raised (ROADMAP A5);
    it is ported (tests/test_torch_parallel.py).  No pairs still raise."""
    with pytest.raises(ValueError):
        port_em.em_train([], device="cpu")


def _far_end_pair(n_ref=9000, lead=300, mlen=200, kins=12):
    """A chained record whose read ends in unaligned bases.  The chainer
    appends the reference's remainder before the read's, so the guide
    ends ``<tail>D <k>I``: it has no trailing deletion run, and in both
    packages its window reaches the end of the reference."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, n_ref).astype(np.int8)
    y = x[lead:lead + mlen].copy()
    idx = rng.integers(0, mlen, mlen // 10)
    y[idx] = (y[idx] + 1) % 4
    y = np.concatenate([y, rng.integers(0, 4, kins).astype(np.int8)])
    guide = [(CIG.D, lead), (CIG.M, mlen), (CIG.D, n_ref - lead - mlen),
             (CIG.I, kins)]
    return x, y, guide


def test_window_to_the_reference_end_breaks_the_recursion_in_both_packages():
    """Under a random start, at W = 64, the window of a ``<tail>D <k>I``
    record holds a deletion run of 8.5 kb with read bases after it.  The
    forward's and the backward's band maxima sit at opposite band edges
    there and their product leaves the f32 range.  The JAX package's XLA
    scan returns finite sums that account for a fraction of the window;
    the port's recursion (the Pallas kernel's, with its 3e37 clamp)
    returns non-finite ones, which ``representable`` rejects.  Both
    log-likelihoods, forward only, agree."""
    import torch

    from nanopore_tpu.align.realign import window_global_pair as jax_window
    from nanopore_tpu.ops.pairhmm import em_expectations
    from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
    from nanopore_tpu.ops.pairhmm import prepare_banded_batch
    from nanopore_tpu_torch.align.realign import window_global_pair
    from nanopore_tpu_torch.ops.pack import pack_stream_pairs, pack_xyc
    from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
    from nanopore_tpu_torch.ops.realign import realign_em

    x, y, guide = _far_end_pair()
    xw, gw, j0, j1 = window_global_pair(x, guide, pad=64)
    want = jax_window(x, guide, pad=64)
    assert (j0, j1) == want[2:] == (236, len(x)) and gw == want[1]
    n, m = len(xw), len(y)

    batch = prepare_banded_batch([(xw, y, gw)], band_width=64)
    jm = JaxModel.random(np.random.default_rng(0))
    ref = em_expectations(batch, jax_params(jm))
    into = np.asarray(ref["trans"], np.float64)[0].sum(axis=0)
    assert np.isfinite(into).all()
    assert into[0] + into[1] + into[3] < 0.5 * n  # most of the window lost

    prep = pack_stream_pairs([(xw, y, gw)], 64, batch.k_max)
    t = torch.from_numpy
    out = realign_em(
        pack_xyc(t(prep["stream"]), t(prep["initx"]), t(prep["m"]),
                 t(prep["n"])),
        t(prep["m"]), t(prep["n"]),
        make_kernel_params(PairHmmModel.random(np.random.default_rng(0))))
    trans = out["trans"].numpy().astype(np.float64)
    emis = out["emis"].numpy().astype(np.float64)
    assert not port_em.representable(trans, emis, np.array([m]),
                                     np.array([n]))[0]
    np.testing.assert_allclose(out["loglik"].numpy(),
                               np.asarray(ref["loglik"]), rtol=1e-5)


def test_representable_accepts_what_the_lattice_accounts_for():
    """Sums that consume the window and the read pass; sums off by more
    than 1 % in either, or non-finite, do not."""
    trans = np.zeros((4, 5, 5))
    trans[:, 0, 0] = 90.0  # matches
    trans[:, 0, 1] = 10.0  # deletions
    trans[:, 0, 2] = 5.0  # insertions
    trans[1, 0, 3] = 30.0  # a read that deletes more than its window
    trans[2, 4, 4] = np.nan
    trans[3] *= 1e30
    emis = np.zeros((4, 5, 16))
    ok = port_em.representable(trans, emis, np.full(4, 95.0),
                               np.full(4, 100.0))
    assert ok.tolist() == [True, False, False, False]
    emis[0, 2, 3] = np.inf
    assert not port_em.representable(trans, emis, np.full(4, 95.0),
                                     np.full(4, 100.0)).any()


def test_em_train_leaves_out_a_read_it_cannot_hold(pairs):
    """The far-end record's counts stay out of the M-step, which is then
    the M-step of the other reads alone; its log-likelihood still counts."""
    from nanopore_tpu_torch.mapping.engine import StageStats

    opts = port_em.EmOptions(trials=1, iterations=1, band_width=64,
                             window_pad=64, batch_size=8, seed=0)
    stats = StageStats()
    got = port_em.em_train(pairs[:2] + [_far_end_pair()], opts,
                           device="cpu", stats=stats)
    assert stats.snapshot()["em_left_out"]["calls"] == 1
    alone = port_em.em_train(pairs[:2], opts, device="cpu")
    np.testing.assert_allclose(got.model.transitions, alone.model.transitions,
                               atol=1e-12)
    np.testing.assert_allclose(got.model.emissions, alone.model.emissions,
                               atol=1e-12)
    assert np.isfinite(got.running_likelihoods[0][0])
    assert got.running_likelihoods[0][0] < alone.running_likelihoods[0][0]
    with pytest.raises(FloatingPointError):
        port_em.em_train([_far_end_pair()], opts, device="cpu")
