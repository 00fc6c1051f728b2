"""Port's plain Viterbi and Viterbi walker vs the JAX package.

The same seeded pairs (match, deletion and insertion guides, N bases,
mixed lengths), packed by each package, at W = 8 and W = 32:

* the JAX Pallas Viterbi in interpret mode (CHUNK/SEG patched small as
  tests/test_pallas_viterbi.py does): score within 1e-5 relative,
  fstate identical and the backpointer plane byte-identical on every
  lattice cell;
* the JAX XLA scan (``viterbi_decode_batch`` + ``viterbi_traceback``):
  score within 1e-5 relative.  Its tables are per-cell logs with
  structure zeros at log(1e-37), so an exact max-product tie (a gap
  shifted within a homopolymer) can break the other way: a cigar may
  differ from the scan's only where the Pallas decode gives the port's;
* the walker: ``viterbi_walk_plain`` on the JAX interpret-mode plane
  gives, after ``rle_ops_batch``, the cigars of ``viterbi_traceback_batch``
  and of the Pallas walker in interpret mode;
* the structure guard: ``viterbi_structure_ok`` agrees with the JAX
  package's on the shipped models and on a model outside the canonical
  fiveState structure, and picks the plane: the int8 byte plane for a
  canonical model (its bits those held above), the int16 full plane for
  the other (``tests/test_torch_viterbi_full.py`` holds that plane
  against the XLA scan).

Each test builds its JAX ``KernelParams`` afresh: the JAX package keeps a
table cache keyed on the transition table's identity.
"""

import numpy as np
import pytest
import torch

import nanopore_tpu.ops.pairhmm_pallas_realign as ppr
import nanopore_tpu.ops.pairhmm_pallas_viterbi as ppv
import nanopore_tpu.ops.traceback_pallas as tbp
from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.io.sam import CIG
from nanopore_tpu.mapping.runner import trained_model_path
from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu.ops.viterbi import viterbi_decode_batch, viterbi_traceback
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.ops import dispatch
from nanopore_tpu_torch.ops.pack import pack_stream_pairs, pack_xyc
from nanopore_tpu_torch.ops.pairhmm import make_kernel_params, params_from_numpy
from nanopore_tpu_torch.ops.realign import untile
from nanopore_tpu_torch.ops.traceback import (
    OP_NONE,
    rle_ops_batch,
    viterbi_walk,
    viterbi_walk_plain,
)
from nanopore_tpu_torch.ops.viterbi import (
    NEG,
    short_step,
    viterbi_forward,
    viterbi_forward_plain,
    viterbi_structure_ok,
    viterbi_tables,
)
from test_torch_traceback import RAGGED_K, ragged_layout


@pytest.fixture(scope="module", autouse=True)
def small_kernel_geometry():
    olds = (ppv.CHUNK, ppv.SEG, ppr.CHUNK, ppr.SEG, tbp.CHUNK)
    ppv.CHUNK, ppv.SEG, ppr.CHUNK, ppr.SEG, tbp.CHUNK = 8, 4, 8, 4, 64
    yield
    ppv.CHUNK, ppv.SEG, ppr.CHUNK, ppr.SEG, tbp.CHUNK = olds
    ppv._pallas_viterbi_call.clear_cache()
    ppr._pallas_realign_call.clear_cache()
    tbp._vit_tb_call.clear_cache()


def mixed_pairs(rng):
    """tests/test_pallas_viterbi.py's three guides, an N in the reference
    and the read, and a longer read with both indels."""
    pairs = []
    x0 = rng.integers(0, 4, 18).astype(np.int8)
    y0 = x0.copy()
    y0[rng.integers(0, 18, 3)] = rng.integers(0, 4, 3)
    pairs.append((x0, y0, [(CIG.M, 18)]))
    x1 = rng.integers(0, 4, 16).astype(np.int8)
    pairs.append((x1, x1[:10].copy(), [(CIG.M, 5), (CIG.D, 6), (CIG.M, 5)]))
    x2 = rng.integers(0, 4, 10).astype(np.int8)
    y2 = np.concatenate([x2[:5], rng.integers(0, 4, 6).astype(np.int8),
                         x2[5:]])
    pairs.append((x2, y2, [(CIG.M, 5), (CIG.I, 6), (CIG.M, 5)]))
    x3 = rng.integers(0, 4, 20).astype(np.int8)
    y3 = x3[:17].copy()
    x3[4] = 4  # N in the reference
    y3[9] = 4  # N in the read
    pairs.append((x3, y3, [(CIG.M, 17), (CIG.D, 3)]))
    x4 = rng.integers(0, 4, 70).astype(np.int8)
    y4 = np.concatenate([x4[:20], x4[28:50],
                         rng.integers(0, 4, 9).astype(np.int8), x4[50:]])
    sub = rng.random(len(y4)) < 0.08
    y4 = np.where(sub, rng.integers(0, 4, len(y4)), y4).astype(np.int8)
    pairs.append((x4, y4, [(CIG.M, 20), (CIG.D, 8), (CIG.M, 22), (CIG.I, 9),
                           (CIG.M, 20)]))
    return pairs


def port_run(pairs, W, K):
    prep = pack_stream_pairs(pairs, W, K)
    t = torch.from_numpy
    m, n = t(prep["m"]), t(prep["n"])
    xyc = pack_xyc(t(prep["stream"]), t(prep["initx"]), m, n)
    out = viterbi_forward_plain(xyc, m, n,
                                make_kernel_params(PairHmmModel.default()))
    return out, xyc, m, n, prep


def lattice_cells(offsets, m, n, W):
    """(k, w) of every lattice cell of diagonals 1..m+n."""
    cells = []
    for k in range(1, m + n + 1):
        for w in range(W):
            j = int(offsets[k]) + w
            if 0 <= j <= n and 0 <= k - j <= m:
                cells.append((k, w))
    return cells


def cigar_consumes(cigar, m, n):
    return (sum(ln for op, ln in cigar if op in (CIG.M, CIG.I)) == m
            and sum(ln for op, ln in cigar if op in (CIG.M, CIG.D)) == n)


@pytest.fixture(scope="module", params=[8, 32])
def case(request):
    W = request.param
    pairs = mixed_pairs(np.random.default_rng(41))
    batch = prepare_banded_batch(pairs, band_width=W)
    want = ppv.pallas_viterbi(batch, jax_params(JaxModel.default()),
                              interpret=True)
    got, xyc, m, n, prep = port_run(pairs, W, batch.k_max)
    return dict(W=W, pairs=pairs, batch=batch, want=want, got=got, xyc=xyc,
                m=m, n=n, prep=prep)


def test_plain_matches_pallas_interpret(case):
    want, got, W = case["want"], case["got"], case["W"]
    np.testing.assert_allclose(got["score"].numpy(),
                               np.asarray(want["score"]), rtol=1e-5)
    np.testing.assert_array_equal(got["fstate"].numpy(),
                                  np.asarray(want["fstate"]))
    bp_j = untile(want["bp_raw"], len(case["pairs"]))
    bp_p = got["bp"].numpy()
    offsets = case["prep"]["offsets"]
    want_offsets = np.asarray(case["batch"].offsets)
    np.testing.assert_array_equal(offsets[:, :want_offsets.shape[1]],
                                  want_offsets)
    for b, (x, y, _) in enumerate(case["pairs"]):
        cells = lattice_cells(offsets[b], len(y), len(x), W)
        ks, ws = np.array(cells).T
        np.testing.assert_array_equal(bp_p[b, ks, ws], bp_j[b, ks, ws])
        assert bp_p[b].max() < 80 and bp_p[b, 0].max() == 0


def test_plain_matches_xla_scan_up_to_ties(case):
    batch, pairs, got = case["batch"], case["pairs"], case["got"]
    scores, fstates, bps = viterbi_decode_batch(
        batch, jax_params(JaxModel.default()))
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(scores),
                               rtol=1e-5)
    ops, end = viterbi_walk_plain(got["bp"], case["xyc"], case["m"],
                                  case["n"], got["fstate"])
    assert not end.any()
    cigars = rle_ops_batch(ops.numpy())
    pallas = ppv.viterbi_traceback_batch(
        case["want"]["bp_raw"], np.asarray(batch.offsets), batch.m, batch.n,
        case["want"]["fstate"])
    offsets, bps, fstates = (np.asarray(a) for a in
                             (batch.offsets, bps, fstates))
    for b, (x, y, _) in enumerate(pairs):
        xla = viterbi_traceback(bps[b], offsets[b], len(y), len(x),
                                int(fstates[b]))
        assert cigars[b] == xla or cigars[b] == pallas[b]
        assert cigar_consumes(cigars[b], len(y), len(x))


def test_walker_matches_jax_walkers_on_the_pallas_plane(case):
    """The port's plain walker on the JAX interpret-mode plane, read for
    read: the XLA walk of the plane and the Pallas walker."""
    batch, pairs, want = case["batch"], case["pairs"], case["want"]
    bp_j = untile(want["bp_raw"], len(pairs))
    K1 = case["xyc"].shape[1] + 1
    bp = np.zeros((len(pairs), K1, case["W"]), np.int8)
    rows = min(K1, bp_j.shape[1])
    bp[:, :rows] = bp_j[:, :rows]
    bp[:, 0] = 0
    fstate = torch.from_numpy(np.asarray(want["fstate"]).astype(np.int32))
    ops, end = viterbi_walk_plain(torch.from_numpy(bp), case["xyc"],
                                  case["m"], case["n"], fstate)
    assert not end.any()
    got = rle_ops_batch(ops.numpy())
    offsets = np.asarray(batch.offsets)
    xla = ppv.viterbi_traceback_batch(want["bp_raw"], offsets, batch.m,
                                      batch.n, want["fstate"])
    pallas = tbp.viterbi_cigars_pallas(
        want["bp_raw"], offsets, np.asarray(batch.m), np.asarray(batch.n),
        np.asarray(want["fstate"]), interpret=True)
    for b, (x, y, _) in enumerate(pairs):
        assert got[b] == xla[b] == pallas[b]
        assert cigar_consumes(got[b], len(y), len(x))
        # one op per path diagonal, none elsewhere
        assert (ops[b] != OP_NONE).sum() == sum(ln for _, ln in got[b])


def test_canonical_model_keeps_the_byte_plane(case):
    """The default model (canonical) takes the int8 byte plane through
    every route (``viterbi_forward``, ``PreparedViterbi``), the bits
    ``test_plain_matches_pallas_interpret`` holds against the Pallas
    kernel, and the full plane's tables are not its tables."""
    from nanopore_tpu_torch.ops.viterbi import viterbi_full_tables

    params = make_kernel_params(PairHmmModel.default())
    assert viterbi_structure_ok(params)
    got = case["got"]
    assert got["bp"].dtype == torch.int8
    a = viterbi_forward(case["xyc"], case["m"], case["n"], params)
    prep = dispatch.prepared_from_pairs(
        {"device": "cpu"}, case["pairs"], params, band_width=case["W"],
        k_max=case["batch"].k_max, prepared_cls=dispatch.PreparedViterbi)
    b = prep.run()
    for key in ("score", "fstate", "bp"):
        assert torch.equal(a[key], got[key])
    # the dispatch lays a band of width 8 into 32 lanes: the live lanes
    # hold the unpadded band's bits
    W, K1 = case["W"], got["bp"].shape[1]
    assert b["bp"].dtype == torch.int8
    assert torch.equal(b["score"], got["score"])
    assert torch.equal(b["fstate"], got["fstate"])
    assert torch.equal(b["bp"][:, :K1, :W], got["bp"])
    assert (viterbi_tables(params)[:25] == NEG).any()
    assert not (viterbi_full_tables(params)[:25] == NEG).any()


def test_wrappers_route_cpu_tensors_to_plain_and_check_inputs(case):
    params = make_kernel_params(PairHmmModel.default())
    a = viterbi_forward(case["xyc"], case["m"], case["n"], params)
    for key in ("score", "fstate", "bp"):
        assert torch.equal(a[key], case["got"][key])
    with pytest.raises(ValueError):
        viterbi_forward(case["xyc"], case["m"].long(), case["n"], params)
    ops, end = viterbi_walk(a["bp"], case["xyc"], case["m"], case["n"],
                            a["fstate"])
    ops_p, end_p = viterbi_walk_plain(a["bp"], case["xyc"], case["m"],
                                      case["n"], a["fstate"])
    assert torch.equal(ops, ops_p) and torch.equal(end, end_p)
    with pytest.raises(ValueError):
        viterbi_walk(a["bp"], case["xyc"], case["m"], case["n"],
                     a["fstate"].long())


def test_walk_off_the_band_reports_its_end_cell(case):
    """A plane that leads the walk out of the band: the walker stops
    short of the origin and reports where (the decode then drops the
    read with a logged error)."""
    got = case["got"]
    bp = torch.zeros_like(got["bp"])  # every state from match: all M
    ops, end = viterbi_walk_plain(bp, case["xyc"], case["m"], case["n"],
                                  torch.zeros_like(got["fstate"]))
    m, n = case["m"].numpy(), case["n"].numpy()
    lost = end.numpy().any(axis=1)
    assert lost[m != n].all() and not lost[m == n].any()


def test_tables_equal_the_jax_log_tables_to_the_bit():
    for name in (None, "blasr_hmm_0.txt", "blasr_hmm_20.txt",
                 "blasr_hmm_40.txt"):
        jm = (JaxModel.load(trained_model_path(name)) if name
              else JaxModel.default())
        pm = (PairHmmModel.load(trained_model_path(name)) if name
              else PairHmmModel.default())
        want = np.concatenate(ppv._log_tables(jax_params(jm)))
        got = viterbi_tables(make_kernel_params(pm)).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[:25] == NEG).sum() == (pm.transitions == 0).sum() > 0


def _noncanonical(params):
    """tests/test_viterbi.py's model outside the fiveState structure:
    gap state 2 entered from gap state 1."""
    t = np.asarray(params.t, np.float64).reshape(5, 5).copy()
    t[1, 2] = 0.05
    t[1] /= t[1].sum()
    return t.astype(np.float32)


@pytest.mark.parametrize("name", [None, "blasr_hmm_0.txt", "blasr_hmm_20.txt",
                                  "blasr_hmm_40.txt", "noncanonical"])
def test_structure_guard_agrees_with_jax(name):
    """The guard agrees with the JAX package's, and where the JAX package
    sends a model to its Pallas kernel (canonical) or its XLA scan (the
    other) the port takes the byte plane or the full plane: through
    ``prepared_from_pairs`` on the CPU, the plane of that dtype, and the
    non-canonical model's cigars those of the JAX package's route."""
    from nanopore_tpu.ops import dispatch as jax_dispatch

    if name in (None, "noncanonical"):
        jm, pm = JaxModel.default(), PairHmmModel.default()
    else:
        jm = JaxModel.load(trained_model_path(name))
        pm = PairHmmModel.load(trained_model_path(name))
    jp, pp = jax_params(jm), make_kernel_params(pm)
    if name == "noncanonical":
        jp = jp._replace(t=_noncanonical(jp))
        pp = params_from_numpy(_noncanonical(pp), pp.e_match_flat,
                               pp.e_gap_flat)
    assert viterbi_structure_ok(pp) is ppv.viterbi_structure_ok(jp)
    assert viterbi_structure_ok(pp) is (name != "noncanonical")
    pairs = mixed_pairs(np.random.default_rng(41))[:2]
    prep = dispatch.prepared_from_pairs({"device": "cpu"}, pairs, pp,
                                        band_width=8,
                                        prepared_cls=dispatch.PreparedViterbi)
    bp = prep.run()["bp"]
    assert bp.dtype == (torch.int16 if name == "noncanonical" else torch.int8)
    if name == "noncanonical":
        scores, cigars = prep.decode()
        want_scores, want = jax_dispatch.prepared_from_pairs(
            {}, pairs, jp, band_width=8,
            prepared_cls=jax_dispatch.PreparedViterbi).decode()
        np.testing.assert_allclose(scores, want_scores, rtol=1e-5)
        assert [list(c) for c in cigars] == [list(c) for c in want]


# ---- ragged batches, as the walker kernel sees them: those of
# test_torch_traceback.py, whose last read, with m + n above k_pad, is
# not walked (all OP_NONE, its end cell (m, n)) ----


@pytest.mark.parametrize("W", [32, 64])
@pytest.mark.parametrize("plane", ["random", "all_match"])
def test_ragged_batch_walker_matches_jax_walkers(W, plane):
    """Random Lipschitz band offsets and a random plane (walks wander
    off the band and end short of the origin) or an all-match plane
    from the match state (only the m == n reads reach the origin): the
    plain walker's op codes and end cells are the XLA scan's, and its op
    codes the Pallas walker's in interpret mode."""
    rng = np.random.default_rng(W + len(plane))
    ms, ns, offsets, xyc = ragged_layout(rng, W)
    B, K1 = len(ms), RAGGED_K + 1
    if plane == "random":
        bp = rng.integers(0, 80, (B, K1, W)).astype(np.int8)
        fstate = rng.integers(0, 5, B).astype(np.int32)
    else:
        bp = np.zeros((B, K1, W), np.int8)
        fstate = np.zeros(B, np.int32)
    t = torch.from_numpy
    ops, end = viterbi_walk_plain(t(bp), t(xyc), t(ms), t(ns), t(fstate))
    ops, end = ops.numpy(), end.numpy()

    NB, BT = 1, tbp.BT
    raw = np.zeros((NB, K1, W, BT), np.int8)
    raw[0, :, :, :B] = bp.transpose(1, 2, 0)
    lanes = lambda a: np.pad(a, (0, BT - B)).reshape(NB, BT)  # noqa: E731
    offs_t = np.zeros((K1, NB, BT), np.int32)
    offs_t[:, 0, :B] = offsets.T
    xla_ops, fi, fj = ppv._viterbi_ops_raw_jit(
        raw, offs_t, lanes(ms), lanes(ns), lanes(fstate))
    xla_ops = np.asarray(xla_ops).transpose(1, 2, 0).reshape(BT, K1)[:B]
    np.testing.assert_array_equal(ops, xla_ops)
    np.testing.assert_array_equal(end[:, 0], np.asarray(fi).reshape(-1)[:B])
    np.testing.assert_array_equal(end[:, 1], np.asarray(fj).reshape(-1)[:B])
    pallas = tbp.viterbi_traceback_ops_pallas(raw, offsets, ms, ns, fstate,
                                              interpret=True)
    np.testing.assert_array_equal(ops, pallas)

    lost = end.any(axis=1)
    assert lost[:-1].any()  # some walk does not reach the origin
    if plane == "all_match":
        assert (lost[:-1] == (ms != ns)[:-1]).all()
    # the capped read: never walked
    assert (ops[-1] == OP_NONE).all() and tuple(end[-1]) == (ms[-1], ns[-1])
    for b in range(B - 1):
        assert (ops[b, ms[b] + ns[b] + 1:] == OP_NONE).all()
    got, got_end = viterbi_walk(t(bp), t(xyc), t(ms), t(ns), t(fstate))
    assert got.equal(t(ops)) and got_end.equal(t(end))


class _PastTheWidthCheck(Exception):
    """Raised by a stand-in for a kernel's build, the first step after a
    wrapper's width check (here and in the other tests of the wrappers'
    width checks)."""


def _past_the_width_check(*args, **kwargs):
    raise _PastTheWidthCheck()


def test_cuda_walker_refuses_other_widths(monkeypatch):
    """A non-CPU tensor of a width the kernels do not serve raises
    before any launch, in the walker and the Viterbi; W = 32, 64 and 128
    pass the check, to the kernel's build (the meta device stands in for
    the card; CPU tensors of any width take the plain versions)."""
    monkeypatch.setattr("nanopore_tpu_torch.kernels.build.library",
                        _past_the_width_check)
    B, K = 3, 10
    meta = dict(device="meta")

    def walk(W):
        viterbi_walk(torch.zeros((B, K + 1, W), dtype=torch.int8, **meta),
                     torch.zeros((B, K, W), dtype=torch.int8, **meta),
                     *(torch.zeros(B, dtype=torch.int32, **meta)
                       for _ in range(3)))

    def forward(W):
        viterbi_forward(torch.zeros((B, K, W), dtype=torch.int8, **meta),
                        *(torch.zeros(B, dtype=torch.int32, **meta)
                          for _ in range(2)),
                        make_kernel_params(PairHmmModel.default()))

    for call in (walk, forward):
        with pytest.raises(ValueError, match="serves? W"):
            call(8)
        for W in (32, 64, 128):
            with pytest.raises(_PastTheWidthCheck):
                call(W)


# ---- the kernel's short step (csrc/viterbi.cu): a gap destination's
# max over its two allowed predecessors, match and itself, against the
# plain version's 5-way max, in numpy f32 ----

F32_NEG = np.float32(NEG)


def _gap_step_5way(a, ltf, g):
    """The plain version's step for gap destination g over (5, N) f32
    predecessor states: the max and the from-self bit (argmax != 0) over
    all five, a tie keeping the lower state."""
    bv = a[0] + ltf[g]
    bs = np.zeros(a.shape[1], np.int32)
    for s in range(1, 5):
        cand = a[s] + ltf[s * 5 + g]
        bs = np.where(cand > bv, s, bs)
        bv = np.maximum(bv, cand)
    return bv, bs != 0


def _gap_step_short(a, ltf, g):
    """The kernel's short step: the max of the two allowed candidates
    and whether the one from itself is strictly larger."""
    from_m = a[0] + ltf[g]
    from_g = a[g] + ltf[g * 6]
    return np.maximum(from_m, from_g), from_g > from_m


def _viterbi_states(rng, ltf, n=4096):
    """(5, n) f32 predecessor states as the recursion holds them: NEG or
    a real log score.  A quarter of the cells are all NEG, a share of
    each state is NEG elsewhere, and for each gap state g some cells
    tie exactly between its two allowed candidates (where both are
    allowed)."""
    a = rng.uniform(-2e6, 0, (5, n)).astype(np.float32)
    a[:, rng.random(n) < 0.25] = F32_NEG
    a[rng.random((5, n)) < 0.3] = F32_NEG
    for g in range(1, 5):
        if min(ltf[g], ltf[g * 6]) <= F32_NEG:
            continue  # no tie between an allowed and a disallowed entry
        idx = rng.choice(n, n // 16, replace=False)
        idx = idx[a[0, idx] > F32_NEG]
        a[g, idx] = (a[0, idx] + ltf[g]) - ltf[g * 6]
    return a


def _short_step_models():
    rng = np.random.default_rng(5)
    out = {"default": PairHmmModel.default()}
    for name in ("blasr_hmm_0.txt", "blasr_hmm_20.txt", "blasr_hmm_40.txt"):
        out[name] = PairHmmModel.load(trained_model_path(name))
    for i in range(3):
        out["random_%d" % i] = PairHmmModel.random(rng)
    return out


@pytest.mark.parametrize("name", sorted(_short_step_models()))
def test_short_step_equals_the_five_way_step(name):
    """Every shipped model and three random canonical ones take the short
    step, and on states with NEG cells, ties at -1e30 (a NEG match
    predecessor beside real disallowed ones) and exact ties between the
    two allowed candidates it gives the 5-way step's values and from-self
    bits, bit for bit."""
    tab = viterbi_tables(make_kernel_params(_short_step_models()[name]))
    assert short_step(tab)
    ltf = tab.numpy()[:25]
    a = _viterbi_states(np.random.default_rng(sum(map(ord, name))), ltf)
    ties = at_neg = 0
    for g in range(1, 5):
        v5, t5 = _gap_step_5way(a, ltf, g)
        vs, ts = _gap_step_short(a, ltf, g)
        np.testing.assert_array_equal(v5.view(np.int32), vs.view(np.int32))
        np.testing.assert_array_equal(t5, ts)
        ties += int(((a[0] + ltf[g]) == (a[g] + ltf[g * 6])).sum())
        at_neg += int(((a[0] + ltf[g]) == F32_NEG).sum())
    assert ties > 0 and at_neg > 0


def _zero_gap_params(entries):
    """The default model's kernel tables with the transitions ``entries``
    ((from, to) pairs) set to 0, each row renormalised."""
    pp = make_kernel_params(PairHmmModel.default())
    t = pp.t.double().numpy().copy()
    for i, j in entries:
        t[i, j] = 0.0
        t[i] /= t[i].sum()
    return params_from_numpy(t, pp.e_match_flat, pp.e_gap_flat)


@pytest.mark.parametrize("entries", [[(2, 2)], [(0, 2)], [(0, 2), (2, 2)]],
                         ids=["self", "from_match", "both"])
def test_zero_gap_transitions_and_the_step_the_host_picks(entries):
    """Gap state 2 with one of its two entries at 0 still takes the short
    step, and it gives the 5-way step's values and bits: the positive
    entry's candidate is at least NEG, so no disallowed one can pass it.
    With both at 0 (a gap state entered from nowhere) the host picks the
    5-way step, and the two differ on cells whose match and own
    predecessors are NEG beside a real disallowed one: the 5-way step's
    bit points away from match while its value is one NEG, the short
    step's stays 0 at 2 NEG.  Those cells are unreachable: both values
    clamp to NEG once the emission is added."""
    g = 2
    differ = len(entries) == 2
    tab = viterbi_tables(_zero_gap_params(entries))
    assert short_step(tab) == (not differ)
    ltf = tab.numpy()[:25]
    a = _viterbi_states(np.random.default_rng(11 + len(entries)), ltf)
    v5, t5 = _gap_step_5way(a, ltf, g)
    vs, ts = _gap_step_short(a, ltf, g)
    bad = t5 != ts
    assert bad.any() == differ
    if differ:
        cells = (a[0] == F32_NEG) & (a[g] == F32_NEG) & (
            a[[1, 3, 4]] > F32_NEG).any(0)
        np.testing.assert_array_equal(bad, cells)
        assert (v5[bad] == F32_NEG).all() and (vs[bad] < F32_NEG).all()
    else:
        np.testing.assert_array_equal(v5.view(np.int32), vs.view(np.int32))
        assert ts.any() == (entries == [(0, 2)])
    e = np.float32(-1.5)
    np.testing.assert_array_equal(np.maximum(v5 + e, F32_NEG),
                                  np.maximum(vs + e, F32_NEG))
