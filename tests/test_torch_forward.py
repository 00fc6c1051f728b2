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
  log-likelihood of every read (tests/test_viterbi.py's bar);
* the kernel's two-term gap sum (csrc/forward.cu): the host predicate
  on every shipped model, a torch model of the sum held bit for bit
  against the 5-way sum on the plain recursion's states, a constructed
  state whose subnormal band maximum parts the two, and a model of the
  kernel's switch to the 5-way sum giving the plain version's bits on
  reads whose band maximum falls subnormal.
"""

import numpy as np
import pytest
import torch

import nanopore_tpu.ops.pairhmm_pallas as pallas_fwd
from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.io.sam import CIG
from nanopore_tpu.mapping.runner import trained_model_path
from nanopore_tpu.ops.pairhmm import forward_loglik as jax_forward_loglik
from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.ops import dispatch
from nanopore_tpu_torch.ops.forward import (
    forward_loglik,
    forward_loglik_plain,
    two_term_sum,
)
from nanopore_tpu_torch.ops.pack import pack_stream_pairs, pack_xyc
from nanopore_tpu_torch.ops.pairhmm import (
    kernel_tables,
    make_kernel_params,
    params_from_numpy,
)
from nanopore_tpu_torch.ops.realign import _seq_sum, _shift, realign_decode_plain
from nanopore_tpu_torch.ops.viterbi import viterbi_forward_plain

from test_pallas import uniform_pairs
from test_torch_viterbi import (
    _past_the_width_check,
    _PastTheWidthCheck,
    mixed_pairs,
)


def _uniform(rng, B, L):
    return uniform_pairs(rng, B, L)


def _n_bases(rng):
    pairs = uniform_pairs(rng, 2, 30)
    pairs[0][0][3] = 4  # N in ref
    pairs[1][1][7] = 4  # N in read
    return pairs


def _noncanonical(t):
    """A transition table outside the fiveState structure: gap state 2
    entered from gap state 1 (tests/test_viterbi.py's), row renormalised."""
    t = np.asarray(t, np.float64).reshape(5, 5).copy()
    t[1, 2] = 0.05
    t[1] /= t[1].sum()
    return t.astype(np.float32)


# (pairs, band width, the JAX kernel's CHUNK, transition table edit):
# tests/test_pallas.py's, and its plain pairs under a model outside the
# canonical structure (the kernel's 5-way sum)
UNIFORM = {
    "plain": (lambda: _uniform(np.random.default_rng(0), 4, 40), 16, None,
              None),
    "n_bases": (lambda: _n_bases(np.random.default_rng(1)), 16, None, None),
    "multi_chunk": (lambda: _uniform(np.random.default_rng(2), 2, 60), 16,
                    32, None),
    "noncanonical": (lambda: _uniform(np.random.default_rng(0), 4, 40), 16,
                     None, _noncanonical),
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
    make, W, chunk, edit = UNIFORM[name]
    pairs = make()
    batch = prepare_banded_batch(pairs, band_width=W)
    jp, pp = jax_params(JaxModel.default()), _params()
    if edit:
        jp = jp._replace(t=edit(jp.t))
        pp = params_from_numpy(edit(pp.t), pp.e_match_flat, pp.e_gap_flat)
        assert not two_term_sum(kernel_tables(pp))
    old = pallas_fwd.CHUNK
    if chunk:
        pallas_fwd.CHUNK = chunk
    try:
        want = np.asarray(pallas_fwd.pallas_forward_loglik(
            batch, jp, interpret=True))
    finally:
        pallas_fwd.CHUNK = old
        pallas_fwd._pallas_forward_call.clear_cache()
    got = forward_loglik_plain(*_port(pairs, W, batch.k_max), pp)
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


def test_cuda_wrapper_refuses_other_widths_and_odd_k_pad(monkeypatch):
    """A non-CPU tensor of a width the kernel does not serve, or of odd
    k_pad, raises before any launch; W = 32, 64 and 128 at even k_pad
    pass the check, to the kernel's build (the meta device stands in for
    the card; CPU tensors of any shape take the plain version)."""
    monkeypatch.setattr("nanopore_tpu_torch.kernels.build.library",
                        _past_the_width_check)
    meta = dict(device="meta")

    def call(K, W):
        forward_loglik(torch.zeros((3, K, W), dtype=torch.int8, **meta),
                       *(torch.zeros(3, dtype=torch.int32, **meta)
                         for _ in range(2)), _params())

    for K, W in ((10, 8), (11, 64), (11, 128)):
        with pytest.raises(ValueError, match="serves W"):
            call(K, W)
    for W in (32, 64, 128):
        with pytest.raises(_PastTheWidthCheck):
            call(10, W)


# ---- the kernel's two-term gap sum (csrc/forward.cu) ----


def _edited(entries, model=None):
    """The kernel params of ``model`` (the default) with the transitions
    ``entries`` ((from, to, value) triples) set, each row renormalised."""
    pp = make_kernel_params(model or PairHmmModel.default())
    t = pp.t.double().numpy().copy()
    for i, j, v in entries:
        t[i, j] = v
        t[i] /= t[i].sum()
    return params_from_numpy(t, pp.e_match_flat, pp.e_gap_flat)


PREDICATE_MODELS = {
    "default": (lambda: _params(), True),
    "random_0": (lambda: make_kernel_params(
        PairHmmModel.random(np.random.default_rng(0))), True),
    "blasr_hmm_0": (lambda: make_kernel_params(
        PairHmmModel.load(trained_model_path("blasr_hmm_0.txt"))), True),
    "blasr_hmm_20": (lambda: make_kernel_params(
        PairHmmModel.load(trained_model_path("blasr_hmm_20.txt"))), True),
    "blasr_hmm_40": (lambda: make_kernel_params(
        PairHmmModel.load(trained_model_path("blasr_hmm_40.txt"))), True),
    "gap_2_zeroed": (lambda: _edited([(0, 2, 0.0), (2, 2, 0.0)]), True),
    "gap_self_zeroed": (lambda: _edited([(1, 1, 0.0), (4, 4, 0.0)]), True),
    "t_1_2_positive": (lambda: _edited([(1, 2, 0.05)]), False),
    "t_4_3_positive": (lambda: _edited([(4, 3, 1e-6)]), False),
    "t_2_1_denormal": (lambda: _edited([(2, 1, 1e-40)]), False),
}


@pytest.mark.parametrize("name", sorted(PREDICATE_MODELS))
def test_two_term_predicate(name):
    """The host takes the two-term sum exactly where the 12 transitions
    from one gap state to another are 0: every shipped model, a random
    EM start and models with gap entries zeroed; any positive entry
    among the 12, however small, sends the model to the 5-way sum."""
    make, want = PREDICATE_MODELS[name]
    tab = kernel_tables(make())
    assert two_term_sum(tab) is want
    tf = tab[:25].reshape(5, 5)
    assert int((tf[1:, 1:] == 0).sum()) >= 12 if want else True


# the band maxima whose reciprocal the kernel's two-term chain takes
# (csrc/forward.cu::rcp_normal); outside, its check fails
RCP_LO, RCP_HI = float(np.finfo(np.float32).tiny), 2.0 ** 126


def _model_run(xyc, m, n, params, mode, chunk=64):
    """A torch model of the kernel's recursion over pairs of diagonals,
    vectorised over reads and band: ``mode`` "five" is the plain
    version's 5-way sum, "two" the two-term gap sum throughout, "switch"
    the kernel's: the two-term sum, checked over each chunk of ``chunk``
    diagonals (every gap state of each pair's two diagonals, before the
    rescale, finite, and each band maximum in [FLT_MIN, 2^126), where the
    two-term chain's reciprocal serves; the kernel's lane sums are no
    less strict) and, where a read's check fails within
    its diagonals, the chunk again from its start and the rest of the
    read with the 5-way sum.  Returns the loglik, every diagonal's
    states, each step's gap sums both ways ((5-way, two-term) on the
    step's inputs) and each read's first 5-way diagonal (or -1)."""
    B, k_pad, W = xyc.shape
    assert k_pad % 2 == 0
    f32 = torch.float32
    tab = kernel_tables(params)
    tf = tab[:25].reshape(5, 5)  # [from, to]
    tfT = tf.t().contiguous()
    emf, egf = tab[25:61], tab[61:91]
    kend = m.long() + n.long()
    klast = torch.clamp(kend, max=k_pad)
    base = torch.arange(W) + 1
    codes = xyc.to(torch.int32) & 0xFF
    tiny = torch.tensor(1e-37, dtype=f32)
    a = torch.zeros((B, 5, W), dtype=f32)
    a[:, :, 0] = 1.0 / 5
    st = {"a": a, "b": torch.zeros((B, 5, W), dtype=f32),
          "rs": torch.ones(B, dtype=f32), "ls": torch.zeros(B, dtype=f32),
          "acc": torch.zeros(B, dtype=f32),
          "five": torch.full((B,), mode == "five")}
    switched = torch.full((B,), -1)
    states, sums = [], []

    def step(k, prev, pp, r):
        c = codes[:, k - 1]
        x, y = (c >> 3) & 7, c & 7
        E = torch.stack([emf[x * 6 + y], egf[6 + x], egf[12 + y],
                         egf[18 + x], egf[24 + y]], dim=1)
        d1, d1p = (c[:, 0] >> 6) & 1, (c[:, 0] >> 7) & 1
        src = torch.cat([pp[:, None], prev[:, None].expand(B, 4, 5, W)], 1)
        T = _seq_sum(tfT[None, :, :, None] * src)
        two = torch.stack([tf[0, g] * prev[:, 0] + tf[g, g] * prev[:, g]
                           for g in range(1, 5)], dim=1)
        sums.append((T[:, 1:], two))
        T = torch.cat([T[:, :1], torch.where(st["five"][:, None, None],
                                             T[:, 1:], two)], dim=1)
        S = torch.stack([d1 + d1p - 1, d1 - 1, d1, d1 - 1, d1], dim=1)
        Ts = _shift(T, S, 0.0, base)
        Ts = torch.cat([(Ts[:, 0] * r[:, None])[:, None], Ts[:, 1:]], dim=1)
        return E * Ts

    def run_chunk(q0):
        """The pairs of the chunk from diagonal q0; True for each read
        whose check fails on a pair it runs."""
        bad = torch.zeros(B, dtype=torch.bool)
        for k0 in range(q0, min(q0 + chunk, k_pad), 2):
            a, b, rs, ls = st["a"], st["b"], st["rs"], st["ls"]
            nb = step(k0 + 1, a, b, rs)
            na = step(k0 + 2, nb, a, torch.ones_like(rs))
            scale = na.amax(dim=(1, 2))
            safe = torch.where(scale > 0, scale, torch.ones_like(scale))
            inv = 1.0 / safe
            ok = (torch.isfinite(nb[:, 1:]).flatten(1).all(1)
                  & torch.isfinite(na[:, 1:]).flatten(1).all(1)
                  & (safe >= RCP_LO) & (safe < RCP_HI))
            bad |= ~ok & (k0 < klast)
            na = na * inv[:, None, None]
            for k, sk, lsk in ((k0 + 1, nb, ls),
                               (k0 + 2, na, ls + torch.log(safe))):
                fin = sk[:, 0, 0]
                for s in range(1, 5):
                    fin = fin + sk[:, s, 0]
                st["acc"] = torch.where(kend == k, st["acc"] + (
                    torch.log(torch.maximum(fin, tiny)) + lsk), st["acc"])
            st.update(a=na, b=nb, rs=inv, ls=ls + torch.log(safe))
            states.extend([nb, na])
        return bad

    for q0 in range(0, k_pad, chunk):
        saved = dict(st), len(states), len(sums)
        newly = run_chunk(q0) & ~st["five"]
        if mode == "switch" and newly.any():
            st.update(saved[0])
            del states[saved[1]:], sums[saved[2]:]
            st["five"] = st["five"] | newly
            switched = torch.where(newly, q0 + 1, switched)
            run_chunk(q0)
    return st["acc"], states, sums, switched


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_two_term_gap_sum_equals_the_five_way_sum_on_the_plain_states(mixed):
    """Fed the plain recursion's states on the mixed fixture (the model's
    5-way recursion gives the plain version's loglik bit for bit), the
    two-term gap sum gives the 5-way sum's bits at every step, and so
    does the recursion run with it."""
    args = (mixed["xyc"], mixed["m"], mixed["n"], _params())
    ll, states, sums, _ = _model_run(*args, "five")
    assert torch.equal(_bits(ll), _bits(mixed["loglik"]))
    assert len(sums) == mixed["xyc"].shape[1]
    for five, two in sums:
        assert torch.isfinite(five).all()
        assert torch.equal(_bits(five), _bits(two))
    for mode in ("two", "switch"):
        ll2, states2, _, switched = _model_run(*args, mode)
        assert torch.equal(_bits(ll2), _bits(ll))
        assert all(torch.equal(_bits(p), _bits(q))
                   for p, q in zip(states, states2))
        assert (switched == -1).all()


def test_a_subnormal_band_maximum_parts_the_two_sums():
    """A constructed even diagonal whose band maximum before the rescale
    is subnormal: 1 / safe overflows to inf, the rescaled states are inf
    (or NaN where they were 0), and the next diagonal's two-term gap sums
    part from the 5-way ones exactly at the cells where another gap
    state is not finite (0 * inf is NaN).  A normal band maximum keeps
    them equal."""
    rng = np.random.default_rng(3)
    tf = kernel_tables(_params())[:25].reshape(5, 5)
    W = 16
    pre = rng.random((5, W)).astype(np.float32)
    pre[rng.random((5, W)) < 0.3] = 0.0
    for top, parts in ((1e-30, False), (2e-39, True)):
        na = torch.from_numpy(pre * np.float32(top / pre.max()))
        safe = na.max()
        inv = 1.0 / safe
        assert bool(safe < np.finfo(np.float32).tiny) is parts
        assert bool(torch.isfinite(inv)) is not parts
        a = na * inv
        five = _seq_sum((tf.t()[None, :, :, None] * a[None, None])
                        )[0, 1:]
        two = torch.stack([tf[0, g] * a[0] + tf[g, g] * a[g]
                           for g in range(1, 5)])
        differ = _bits(five) != _bits(two)
        assert bool(differ.any()) is parts
        if parts:
            for g in range(1, 5):
                others = [s for s in range(1, 5) if s != g]
                bad = (~torch.isfinite(a[others])).any(0)
                assert bad.any() and torch.isnan(five[g - 1][bad]).all()
                assert not differ[g - 1][~bad].any()
                assert differ[g - 1][bad & ~torch.isnan(two[g - 1])].all()


def _n_run_case():
    """Reads with a run of N bases against an N-free reference, under the
    default model with every emission of an N set to 1e-40: once the
    band's last cell before the run leaves it, the band maximum falls by
    ~1e-40 in one pair of diagonals, to a subnormal (1 / safe = inf).  A
    read without N keeps its finite loglik."""
    rng = np.random.default_rng(9)
    pairs = []
    for L, p0, ln in ((60, 20, 24), (70, 30, 20), (50, 10, 30), (56, 0, 0)):
        x = rng.integers(0, 4, L).astype(np.int8)
        y = x.copy()
        y[p0:p0 + ln] = 4
        pairs.append((x, y, [(CIG.M, L)]))
    pp = _params()
    em = pp.e_match_flat.numpy().reshape(5, 5).copy()
    eg = pp.e_gap_flat.numpy().reshape(5, 5).copy()
    em[:, 4] = em[4, :] = eg[:, 4] = np.float32(1e-40)
    return pairs, params_from_numpy(pp.t, em.reshape(-1), eg.reshape(-1))


def test_the_switch_to_the_five_way_sum_gives_the_plain_bits():
    """On the N-run reads the two-term recursion's states part from the
    plain version's once the band maximum falls subnormal; the model of
    the kernel's switch sends each such read to the 5-way sum from the
    start of the chunk whose check failed (at chunks of 64 diagonals,
    the kernel's, and of 2, a check a pair: mid-read), and then every
    state and the loglik are the plain version's bit for bit (NaN for
    the N-run reads, finite for the read without N)."""
    pairs, pp = _n_run_case()
    xyc, m, n = _port(pairs, 8)
    assert two_term_sum(kernel_tables(pp))
    want = forward_loglik_plain(xyc, m, n, pp)
    ll5, st5, _, _ = _model_run(xyc, m, n, pp, "five")
    assert torch.equal(_bits(ll5), _bits(want))
    kend = (m + n).long()
    for chunk in (64, 2):
        ll, st, _, switched = _model_run(xyc, m, n, pp, "switch", chunk)
        assert torch.equal(_bits(ll), _bits(want))
        assert all(torch.equal(_bits(p), _bits(q)) for p, q in zip(st, st5))
        assert ((switched >= 1) & (switched < kend)).tolist() == [
            True] * 3 + [False]
        assert chunk == 64 or (switched[:3] > 1).all()
        assert switched[3] == -1 and torch.isfinite(want[3])
        assert ((switched[:3] - 1) % chunk == 0).all()
    assert torch.isnan(want[:3]).all()
    _, st2, _, _ = _model_run(xyc, m, n, pp, "two")
    assert not all(torch.equal(_bits(p), _bits(q)) for p, q in zip(st2, st5))
