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
from nanopore_tpu.mapping.runner import trained_model_path
from nanopore_tpu.ops.mea import mea_traceback_fwd, realign_fused
from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.ops.pack import pack_stream_pairs, pack_xyc
from nanopore_tpu_torch.ops import realign as port_realign
from nanopore_tpu_torch.ops.pairhmm import kernel_tables, make_kernel_params
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


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_plain_lookups_in_batches_give_the_one_at_a_time_bits(monkeypatch,
                                                             chunk):
    """The plain versions take their code lookups (emission factors,
    shift indices, EM bins) ``LOOKUP_DIAGS`` diagonals at a time on one
    intra-op thread and one at a time on several: every mode and the
    forward-only loglik give the same bits either way, at a chunk that
    divides nothing (7) and at the card's 64, on a live width with dead
    lanes over several chunks."""
    from nanopore_tpu_torch.ops import forward as port_forward

    pairs = mixed_pairs(np.random.default_rng(29))
    prep = pack_stream_pairs(pairs, 48, lanes=64)
    t = torch.from_numpy
    m, n = t(prep["m"]), t(prep["n"])
    xyc = pack_xyc(t(prep["stream"]), t(prep["initx"]), m, n, 48)
    params = make_kernel_params(PairHmmModel.random(np.random.default_rng(5)))

    def outputs():
        return [
            port_realign.realign_decode_plain(xyc, m, n, params, 0.5, 0.1,
                                              True, 48),
            port_realign.realign_em_plain(xyc, m, n, params, 48),
            port_realign.realign_gamma_plain(xyc, m, n, params, 48),
            port_realign.realign_exp_plain(xyc, m, n, params, 1e-3, 48),
            {"loglik": port_forward.forward_loglik_plain(xyc, m, n, params)},
        ]

    before = torch.get_num_threads()
    try:
        torch.set_num_threads(2)  # one diagonal at a time
        want = outputs()
        torch.set_num_threads(1)
        monkeypatch.setattr(port_realign, "LOOKUP_DIAGS", chunk)
        got = outputs()
    finally:
        torch.set_num_threads(before)
    for g, w in zip(got, want):
        for key in w:
            assert torch.equal(g[key].isnan(), w[key].isnan()), key
            assert torch.equal(g[key].nan_to_num(7.0), w[key].nan_to_num(7.0)), key


# ---- the kernel's launch plan (ops.realign.workspace_plan) ----

PLAN_W = 64
DIAG_BYTES = 5 * PLAN_W * 4  # forward states of one diagonal at W = 64


def _plan_lengths(rng, count, lo, hi):
    m = rng.integers(lo, hi, count)
    return m, rng.integers(lo, hi, count)


@pytest.mark.parametrize("cap", [10_000, 150_000, 1 << 30])
def test_workspace_plan_offsets_are_prefix_sums_in_read_order(cap):
    m, n = _plan_lengths(np.random.default_rng(cap), 40, 1, 60)
    offsets, launches = port_realign.workspace_plan(m, n, PLAN_W, cap)
    nbytes = port_realign.read_workspace_bytes(m + n, PLAN_W)
    assert offsets[0] == 0 and offsets.dtype == np.int64
    np.testing.assert_array_equal(np.diff(offsets), nbytes)
    # each read: kq = m + n rounded up to even rows of states, then
    # kq + 1 rescale inverses padded to 16 bytes
    kq = m + n + ((m + n) & 1)
    np.testing.assert_array_equal(
        nbytes, kq * DIAG_BYTES + -(-(kq + 1) // 4) * 16)
    assert (offsets % 16 == 0).all()
    # runs of reads in batch order, covering the batch once
    assert launches[0][0] == 0 and launches[-1][1] == len(m)
    for (a0, a1), (b0, _) in zip(launches, launches[1:]):
        assert a0 < a1 == b0
    for r0, r1 in launches:
        assert offsets[r1] - offsets[r0] <= cap or r1 - r0 == 1


def test_workspace_plan_puts_a_read_over_the_cap_alone():
    m = np.array([10, 10, 400, 10, 10])
    n = np.array([10, 10, 400, 10, 10])
    cap = 50 * DIAG_BYTES
    offsets, launches = port_realign.workspace_plan(m, n, PLAN_W, cap)
    assert (2, 3) in launches
    assert launches == [(0, 2), (2, 3), (3, 5)]
    assert offsets[3] - offsets[2] > cap


def test_workspace_plan_fits_the_em_batch_in_one_launch():
    """503 reads of ~10,100 diagonals and 9 far-end windows of up to
    53,248 (chip_smoke.py's EM batch) fit one launch under the cap; the
    workspace of B x k_pad rows a read needed 5."""
    rng = np.random.default_rng(5)
    m = np.concatenate([rng.integers(4700, 5000, 503),
                        rng.integers(4700, 5000, 9)])
    n = np.concatenate([10_100 - m[:503],
                        np.linspace(32_000, 48_240, 9).astype(np.int64)])
    offsets, launches = port_realign.workspace_plan(
        m, n, PLAN_W, port_realign.WORKSPACE_BYTES)
    assert launches == [(0, 512)]
    assert offsets[-1] <= port_realign.WORKSPACE_BYTES
    k_pad = 53_248
    per_read = k_pad * DIAG_BYTES + (k_pad + 1) * 4
    assert -(-512 // (port_realign.WORKSPACE_BYTES // per_read)) == 5


def _far_end_pairs(seed):
    """A short read and one five times longer beside it."""
    rng = np.random.default_rng(seed)
    pairs = []
    for L in (16, 80):
        x = rng.integers(0, 4, L).astype(np.int8)
        y = np.concatenate([x[:L // 2], x[L // 2 + 3:]]).copy()
        y[rng.integers(0, len(y), 2)] = rng.integers(0, 4, 2)
        pairs.append((x, y, [(CIG.M, L // 2), (CIG.D, 3),
                             (CIG.M, L - L // 2 - 3)]))
    return pairs


def test_short_read_beside_one_five_times_longer_decodes_as_alone():
    """The premise of the kernel's per-read extent: a read's loglik,
    score and direction codes do not depend on a read five times longer
    in its batch, and its rows past m + n are DIR_NONE."""
    pairs = _far_end_pairs(3)
    both, _, prep = _port(pairs, None)
    alone, _, prep1 = _port(pairs[:1], None)
    assert prep["k_pad"] > prep1["k_pad"] or \
        prep["k_end"][1] >= 5 * prep["k_end"][0]
    for key in ("loglik", "score"):
        assert torch.equal(both[key][0], alone[key][0])
    K1 = alone["dirs"].shape[1]
    assert torch.equal(both["dirs"][0, :K1], alone["dirs"][0])
    kend = int(prep["k_end"][0])
    assert (both["dirs"][0, kend + 1:] == port_realign.DIR_NONE).all()


@pytest.mark.parametrize("cap", [10_000, 150_000, 1 << 30])
def test_launch_offsets_hold_each_read_to_its_own_slot(cap):
    """The kernel's ``woff``: per launch its reads' offsets from the
    launch's workspace start, then the end of its last slot; a slot is
    exactly what the kernel needs for kq = m + n rounded up to even (the
    kernel's device-side guard), and two diagonals fewer would not fit."""
    m, n = _plan_lengths(np.random.default_rng(cap + 1), 40, 1, 60)
    offsets, launches = port_realign.workspace_plan(m, n, PLAN_W, cap)
    woff = port_realign.launch_offsets(offsets, launches)
    assert woff.dtype == np.int64 and len(woff) == len(m) + len(launches)
    kq = m + n + ((m + n) & 1)
    need = kq * 5 * PLAN_W + (kq + 1 + 3) // 4 * 4  # floats, as the kernel
    for l, (r0, r1) in enumerate(launches):
        sl = woff[r0 + l:r1 + l + 1]
        assert sl[0] == 0
        np.testing.assert_array_equal(np.diff(sl), need[r0:r1])
        short = (kq[r0:r1] - 2) * 5 * PLAN_W + (kq[r0:r1] - 1 + 3) // 4 * 4
        assert ((need[r0:r1] > short)).all()
    assert woff.max() * 4 == max(offsets[r1] - offsets[r0]
                                 for r0, r1 in launches)


def _mea_slot_floats(kq):
    """csrc/realign.cu::mea_slot_floats: forward states, sf and safe
    (kq + 1 floats each, padded to 4), kq // 8 + 1 checkpoints of 6 band
    rows."""
    kp4 = (kq + 1 + 3) // 4 * 4
    return kq * 5 * PLAN_W + 2 * kp4 + (kq // 8 + 1) * 6 * PLAN_W


@pytest.mark.parametrize("cap", [10_000, 150_000, 1 << 30])
def test_mea_workspace_plan_holds_states_scales_and_checkpoints(cap):
    """The decode modes' slot: the forward's states and rescale
    inverses, the backward's scales, then one checkpoint (the five
    states the backward carries and the match state of the diagonal
    above them, 6 x W f32) per segment of 8 diagonals of 0..kq, so
    ceil((kq + 1) / 8) of them; every slot 16-byte aligned, and
    ``launch_offsets`` holds each read to its own slot."""
    m, n = _plan_lengths(np.random.default_rng(cap + 2), 40, 1, 60)
    m[:3], n[:3] = (1, 0, 3), (2, 0, 4)  # a read shorter than a segment
    offsets, launches = port_realign.workspace_plan(m, n, PLAN_W, cap,
                                                    port_realign.DECODE)
    kq = m + n + ((m + n) & 1)
    segments = -(-(kq + 1) // port_realign.SEGMENT)
    np.testing.assert_array_equal(segments, kq // 8 + 1)
    nbytes = port_realign.read_workspace_bytes(m + n, PLAN_W,
                                             port_realign.DECODE)
    np.testing.assert_array_equal(
        nbytes, kq * DIAG_BYTES + 2 * (-(-(kq + 1) // 4) * 16)
        + segments * 6 * PLAN_W * 4)
    np.testing.assert_array_equal(np.diff(offsets), nbytes)
    np.testing.assert_array_equal(nbytes, _mea_slot_floats(kq) * 4)
    assert (offsets % 16 == 0).all()
    for r0, r1 in launches:
        assert offsets[r1] - offsets[r0] <= cap or r1 - r0 == 1
    woff = port_realign.launch_offsets(offsets, launches)
    for l, (r0, r1) in enumerate(launches):
        sl = woff[r0 + l:r1 + l + 1]
        assert sl[0] == 0
        np.testing.assert_array_equal(np.diff(sl), _mea_slot_floats(kq[r0:r1]))
        assert (_mea_slot_floats(kq[r0:r1] + 2) > np.diff(sl)).all()
    # the other modes' slots are what they were
    np.testing.assert_array_equal(
        port_realign.read_workspace_bytes(m + n, PLAN_W),
        kq * DIAG_BYTES + -(-(kq + 1) // 4) * 16)


def test_mea_workspace_plan_fits_the_mapping_batch_in_one_launch():
    """chip_smoke.py's mapping batch (512 reads, m + n of ~9,750 and up
    to its k_pad of 10,240, W = 64) stays one decode launch with the
    checkpoints: two would run the chain twice."""
    rng = np.random.default_rng(9)
    m = rng.integers(4700, 5000, 512)
    n = rng.integers(9_500, 10_240, 512) - m
    n[0] = 10_240 - m[0]
    offsets, launches = port_realign.workspace_plan(
        m, n, PLAN_W, port_realign.WORKSPACE_BYTES, port_realign.DECODE)
    assert launches == [(0, 512)]
    assert offsets[-1] <= port_realign.WORKSPACE_BYTES
    assert port_realign.MEA_MODES == (port_realign.DECODE,
                                      port_realign.DECODE_GAMMA)


@pytest.mark.parametrize("W", [32, 64, 128])
def test_mea_split_budget_fits_the_workspace_cap(W):
    """The realign stage splits its decode windows at
    ``max_workspace_k(W, DECODE)``: a window of that many diagonals
    plans as one launch whose slot (checkpoints and scales included)
    fits ``WORKSPACE_BYTES``, and two diagonals more would not.  The SNP
    caller's exp-mode budget keeps the forward-state formula."""
    cap = port_realign.WORKSPACE_BYTES
    k = port_realign.max_workspace_k(W, port_realign.DECODE)
    offsets, launches = port_realign.workspace_plan([k // 2], [k - k // 2],
                                                    W, cap, port_realign.DECODE)
    assert launches == [(0, 1)] and offsets[-1] <= cap
    assert port_realign.read_workspace_bytes(k + 2, W, port_realign.DECODE) > cap
    assert k < port_realign.max_workspace_k(W) == (cap - 4) // (5 * W * 4 + 4)
    assert port_realign.read_workspace_bytes(
        port_realign.max_workspace_k(W) - 1, W) <= cap


_KEND_FUNCS = {
    "decode": lambda x, m, n, p, k: realign_decode(x, m, n, p, kend=k),
    "em": lambda x, m, n, p, k: port_realign.realign_em(x, m, n, p, kend=k),
    "gamma": lambda x, m, n, p, k: port_realign.realign_gamma(x, m, n, p,
                                                              kend=k),
    "exp": lambda x, m, n, p, k: port_realign.realign_exp(x, m, n, p,
                                                          kend=k),
}
_BAD_KEND = {
    "wrong_length": lambda kend: kend[:-1],
    "length_one": lambda kend: kend[:1],
    "two_d": lambda kend: kend[None, :],
    "float": lambda kend: kend.astype(np.float64),
    "negative": lambda kend: np.where(np.arange(len(kend)) == 1, -1, kend),
}


@pytest.mark.parametrize("bad", sorted(_BAD_KEND))
@pytest.mark.parametrize("func", sorted(_KEND_FUNCS))
def test_public_realign_functions_check_kend_on_the_cpu(func, bad):
    """A ``kend`` of the wrong length or shape, of floats or with a
    negative value raises ValueError naming it, before the functions
    branch on the device (ROADMAP C8)."""
    pairs = mixed_pairs(np.random.default_rng(17))
    prep = pack_stream_pairs(pairs, W)
    t = torch.from_numpy
    m, n = t(prep["m"]), t(prep["n"])
    xyc = pack_xyc(t(prep["stream"]), t(prep["initx"]), m, n)
    params = make_kernel_params(PairHmmModel.default())
    kend = prep["k_end"].astype(np.int64)
    with pytest.raises(ValueError, match="kend"):
        _KEND_FUNCS[func](xyc, m, n, params, _BAD_KEND[bad](kend))


def test_kend_above_k_pad_is_accepted():
    """A capped batch can hold reads with m + n above k_pad: such a kend
    passes the check, as int32 and as int64.  (On the card,
    ``chip_smoke.py`` passes one to the realign kernel and holds the
    outputs to those of the launch without it.)"""
    k_pad = 512
    for dtype in (np.int32, np.int64):
        port_realign.check_kend(np.array([3, k_pad + 7, k_pad], dtype), 3)
    port_realign.check_kend(None, 3)


# ---- the gamma mode's split (csrc/realign.cu gamma_kernel): the forward's
# match rows and rescale inverses, the backward's match rows and scales,
# then the serial g chain and one product pass ----


def _gamma_split(xyc, m, n, params):
    """A CPU model of the gamma kernel's data flow, taken from the plain
    version's own recursion (ops/realign.py::_realign_plain): the
    forward keeps only each diagonal's match row, its rescale inverses
    and the end mass; the backward, run without the forward, keeps only
    its match row and its scale per diagonal; then g_k over k = k_pad..0
    as one serial chain, and gamma = (f * b) * g over every cell."""
    B, k_pad, W = xyc.shape
    f32 = torch.float32
    tab = kernel_tables(params)
    tf = tab[:25].reshape(5, 5)
    emf, egf = tab[25:61], tab[61:91]
    tfT = tf.t().contiguous()
    kend = m.long() + n.long()
    base = torch.arange(W) + 1
    codes = xyc.to(torch.int32) & 0xFF

    def emissions(k):
        c = codes[:, k - 1]
        x, y = (c >> 3) & 7, c & 7
        E = torch.stack([emf[x * 6 + y], egf[6 + x], egf[12 + y],
                         egf[18 + x], egf[24 + y]], dim=1)
        return E, (c[:, 0] >> 6) & 1, (c[:, 0] >> 7) & 1

    # the forward: match rows (row 0 = diagonal 0), sf, loglik, fin_end
    fm = torch.zeros((B, k_pad + 1, W), dtype=f32)
    prev = torch.zeros((B, 5, W), dtype=f32)
    prev[:, :, 0] = 1.0 / 5
    fm[:, 0] = prev[:, 0]
    prevprev = torch.zeros_like(prev)
    sfinv = torch.ones((B, k_pad + 2), dtype=f32)
    rs = torch.ones(B, dtype=f32)
    ls_hi, ls_c, acc = (torch.zeros(B, dtype=f32) for _ in range(3))
    fin_end = torch.ones(B, dtype=f32)
    tiny = torch.tensor(1e-37, dtype=f32)
    for k in range(1, k_pad + 1):
        E, d1, d1p = emissions(k)
        src = torch.cat([prevprev[:, None],
                         prev[:, None].expand(B, 4, 5, W)], dim=1)
        T = port_realign._seq_sum(tfT[None, :, :, None] * src)
        S = torch.stack([d1 + d1p - 1, d1 - 1, d1, d1 - 1, d1], dim=1)
        Ts = port_realign._shift(T, S, 0.0, base)
        r = rs if k % 2 else torch.ones_like(rs)
        Ts = torch.cat([(Ts[:, 0] * r[:, None])[:, None], Ts[:, 1:]], dim=1)
        new = E * Ts
        if k % 2 == 0:
            scale = new.amax(dim=(1, 2))
            safe = torch.where(scale > 0, scale, torch.ones_like(scale))
            inv = 1.0 / safe
            new = new * inv[:, None, None]
            y_ = torch.log(safe) - ls_c
            t_ = ls_hi + y_
            ls_c = (t_ - ls_hi) - y_
            ls_hi = t_
            sfinv[:, k] = inv
            rs = inv
        fin = new[:, 0, 0]
        for s in range(1, 5):
            fin = fin + new[:, s, 0]
        is_end = kend == k
        fin_c = torch.maximum(fin, tiny)
        fin_end = torch.where(is_end, fin_c, fin_end)
        acc = torch.where(is_end, acc + (torch.log(fin_c) + (ls_hi - ls_c)),
                          acc)
        fm[:, k] = new[:, 0]
        prevprev, prev = prev, new

    # the backward alone: match rows and scales
    bm = torch.zeros((B, k_pad + 1, W), dtype=f32)
    safes = torch.ones((B, k_pad + 1), dtype=f32)
    b1 = torch.zeros((B, 5, W), dtype=f32)
    b2 = torch.zeros_like(b1)
    binv = torch.ones(B, dtype=f32)
    E1 = torch.zeros_like(b1)
    em2 = torch.zeros((B, W), dtype=f32)
    d1n1 = d1n2 = torch.zeros(B, dtype=torch.int32)
    end_band = torch.zeros((5, W), dtype=f32)
    end_band[:, 0] = 1.0
    for k in range(k_pad, -1, -1):
        d2n2 = d1n1 + d1n2 - 1
        P = torch.stack([b2[:, 0] * em2, b1[:, 1] * E1[:, 1],
                         b1[:, 2] * E1[:, 2], b1[:, 3] * E1[:, 3],
                         b1[:, 4] * E1[:, 4]], dim=1)
        S = torch.stack([-d2n2, 1 - d1n1, -d1n1, 1 - d1n1, -d1n1], dim=1)
        dest = port_realign._shift(P, S, 0.0, base)
        dest = torch.cat([(dest[:, 0] * binv[:, None])[:, None],
                          dest[:, 1:]], dim=1)
        new = port_realign._seq_sum(tf[None, :, :, None]
                                    * dest[:, None, :, :])
        new = torch.where((kend == k)[:, None, None], end_band[None], new)
        inv = torch.ones(B, dtype=f32)
        if k % 2 == 1 or k == 0:
            scale = new.amax(dim=(1, 2))
            safe = torch.where(scale > 0, scale, torch.ones_like(scale))
            inv = 1.0 / safe
            new = new * inv[:, None, None]
            safes[:, k] = safe
        bm[:, k] = new[:, 0]
        if k == 0:
            break
        b2, b1, binv = b1, new, inv
        Ek, d1k, _ = emissions(k)
        em2, E1 = E1[:, 0], Ek
        d1n2, d1n1 = d1n1, d1k

    # the serial g chain, then the product
    inv_fin = 1.0 / fin_end
    g = torch.empty((B, k_pad + 1), dtype=f32)
    g_next = torch.zeros(B, dtype=f32)
    for k in range(k_pad, -1, -1):
        g_k = torch.where(kend == k, inv_fin,
                          (g_next * sfinv[:, k + 1]) * safes[:, k])
        g[:, k] = g_next = torch.clamp(g_k, max=3e37)
    return {"loglik": acc, "gamma": (fm * bm) * g[:, :, None]}


def _gamma_ragged_pairs(seed):
    """Four reads of unequal length: one whose m + n is the batch's
    k_pad (K_ALIGN = 128), one window that runs to the reference's end
    (a read-end insert after a deletion, ROADMAP C6), a short one and one
    with a 4-base deletion."""
    rng = np.random.default_rng(seed)

    def bases(L):
        return rng.integers(0, 4, L).astype(np.int8)

    x0 = bases(64)
    y0 = x0.copy()
    y0[rng.integers(0, 64, 6)] = bases(6)
    x1 = bases(70)
    y1 = np.concatenate([x1[:40], bases(5)])
    x2 = bases(12)
    x3 = bases(50)
    y3 = np.concatenate([x3[:20], x3[24:]])
    return [
        (x0, y0, [(CIG.M, 64)]),                            # m + n = 128
        (x1, y1, [(CIG.M, 40), (CIG.D, 30), (CIG.I, 5)]),   # to the end
        (x2, x2.copy(), [(CIG.M, 12)]),
        (x3, y3, [(CIG.M, 20), (CIG.D, 4), (CIG.M, 26)]),
    ]


@pytest.mark.parametrize("W_", [8, 32])
@pytest.mark.parametrize("capped", [False, True])
def test_gamma_split_matches_the_plain_gamma_mode(W_, capped):
    """The gamma kernel's split (forward and backward apart, each keeping
    its match rows and scales, then the g chain and the product) gives
    ``realign_gamma_plain``'s loglik and gamma band bit for bit, on a
    ragged batch with a read at k_pad and a window to the reference's
    end; ``capped`` raises one read's m past k_pad (its end diagonal
    never comes: g stays 0)."""
    pairs = _gamma_ragged_pairs(17 + W_)
    prep = pack_stream_pairs(pairs, W_, None)
    assert prep["k_pad"] == 128 and int(prep["k_end"].max()) == 128
    t = torch.from_numpy
    m, n = t(prep["m"]), t(prep["n"])
    xyc = pack_xyc(t(prep["stream"]), t(prep["initx"]), m, n)
    if capped:
        m = m.clone()
        m[3] += prep["k_pad"]
    params = make_kernel_params(PairHmmModel.load(
        trained_model_path("blasr_hmm_0.txt")))
    want = port_realign.realign_gamma_plain(xyc, m, n, params)
    got = _gamma_split(xyc, m, n, params)
    for key in ("loglik", "gamma"):
        assert torch.equal(got[key].view(torch.int32),
                           want[key].view(torch.int32)), key
    assert torch.isfinite(want["gamma"]).all()
    assert (want["gamma"][:, :, 0] > 0).any()


def _gamma_slot_floats(kq):
    """csrc/realign.cu::gamma_slot_floats: the backward's match rows of
    diagonals 0..kq, then sf and safe (kq + 1 floats each, padded to 4)."""
    kp4 = (kq + 1 + 3) // 4 * 4
    return (kq + 1) * PLAN_W + 2 * kp4


@pytest.mark.parametrize("cap", [10_000, 150_000, 1 << 30])
def test_gamma_workspace_plan_holds_match_rows_and_scales(cap):
    """The gamma mode's slot through ``workspace_plan``: one band row a
    diagonal (the backward's match state; the forward's goes to the
    gamma band) and the two scale vectors, every slot 16-byte aligned,
    about a fifth of the 5-state slot, and ``launch_offsets`` holding
    each read to its own slot."""
    m, n = _plan_lengths(np.random.default_rng(cap + 3), 40, 1, 60)
    m[:2], n[:2] = (0, 1), (0, 2)
    offsets, launches = port_realign.workspace_plan(m, n, PLAN_W, cap,
                                                    port_realign.GAMMA)
    kq = m + n + ((m + n) & 1)
    nbytes = port_realign.read_workspace_bytes(m + n, PLAN_W,
                                             port_realign.GAMMA)
    np.testing.assert_array_equal(nbytes, _gamma_slot_floats(kq) * 4)
    np.testing.assert_array_equal(np.diff(offsets), nbytes)
    assert (offsets % 16 == 0).all()
    full = port_realign.read_workspace_bytes(m + n, PLAN_W)
    assert (4 * nbytes[kq > 100] < full[kq > 100]).all()
    for r0, r1 in launches:
        assert offsets[r1] - offsets[r0] <= cap or r1 - r0 == 1
    woff = port_realign.launch_offsets(offsets, launches)
    for l, (r0, r1) in enumerate(launches):
        sl = woff[r0 + l:r1 + l + 1]
        assert sl[0] == 0
        np.testing.assert_array_equal(np.diff(sl),
                                      _gamma_slot_floats(kq[r0:r1]))
        assert (_gamma_slot_floats(kq[r0:r1] + 2) > np.diff(sl)).all()
