"""Band widths 129 to 256 in the port's W = 256 layout (the MEA path),
on the CPU, against the JAX package's XLA-scan route at the same width.

A band of live width 128 < w <= 256 lies in the first w lanes of
W = 256 lanes (``ops.pack.padded_width``), its dead lanes all sentinel,
on either device.  On the card the MEA path's kernels (pack, realign in
every mode with the band held by two warps, the MEA walker) serve these
widths, and so do the Viterbi path's (the Viterbi and the forward-only
kernel with the band on two warps, the Viterbi walker), which
tests/test_torch_wider_viterbi.py holds at them.  At w = 200 (dead
lanes) and w = 256 (none):

* the packed codes: lanes < w those of the JAX package's packs at w,
  lanes >= w the sentinel with the row's bits 6-7; and a numpy model of
  csrc/pack.cu's chunks at W = 256 (its chunk of 256 diagonals as wide
  as the band) byte for byte the plain pack;
* at w = 200, every realign mode in the padded layout gives, bit for
  bit in the live lanes, what the plain versions give on the unpadded
  band of width 200;
* against the JAX package at w: realign loglik <= 1e-5 relative with
  identical MEA cigars (``realign_fused``); the gamma band <= 5e-5
  (``forward_backward``); the retire rows and flush <= 5e-5 (the XLA
  retire scan); EM sums within 3e-5 of each table's largest entry
  (``em_expectations``);
* at w = 200: ``em_train`` (models within 3e-5 relative) and
  ``realign_sam_file`` (records equal);
* the EM mode's lane sums at W = 256 are the kernel's order: 64 lanes
  of 4 cells, the two warps' sums added lane for lane, then one warp's
  butterfly;
* the decode's workspace plan puts the card's mapping batch at W = 256
  into four launches;
* the width guard without a card: every entry point of either path
  takes 129, 200 and 256 past the guard, every path refuses 1, 2049 and
  4096 and the Viterbi path's entry points alone 1025, naming C11 (the
  MEA path serves 257 to 512 since ROADMAP C11's third step,
  tests/test_torch_widest.py, and 513 to 1024 since its fifth,
  tests/test_torch_w1024.py; the Viterbi path 257 to 512 since its
  fourth, tests/test_torch_widest_viterbi.py, and 513 to 1024 since its
  sixth, tests/test_torch_w1024_viterbi.py), and the CPU serves 600, in
  the W = 768 layout, on the Viterbi path too, against the JAX
  package.
"""

import numpy as np
import pytest
import torch

from nanopore_tpu.align import em as jax_em
from nanopore_tpu.align import realign as jax_realign
from nanopore_tpu.ops import posteriors as jax_post
from nanopore_tpu.ops.mea import mea_traceback_fwd, realign_fused
from nanopore_tpu.ops.pairhmm import em_expectations, forward_backward
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu.ops.pairhmm_pallas_realign import pack_pallas_pairs
from nanopore_tpu.ops.viterbi import viterbi_decode_batch, viterbi_traceback
from nanopore_tpu_torch.align import em as port_em
from nanopore_tpu_torch.align import realign as port_realign_stage
from nanopore_tpu_torch.ops import dispatch
from nanopore_tpu_torch.ops import realign as port_realign
from nanopore_tpu_torch.ops.pack import (
    SENT,
    check_band_width,
    padded_width,
)
from nanopore_tpu_torch.ops.realign import (
    DIR_NONE,
    em_lanes,
    realign_decode,
    realign_gamma,
    untile,
)
from nanopore_tpu_torch.ops.traceback import (
    mea_walk,
    rle_ops_batch,
    viterbi_walk,
)
from test_torch_chain_realign import (  # noqa: F401
    mapped,
    sam_records,
)
from test_torch_em import _global_pairs
from test_torch_pack import _plain, _scan_lookup_pack
from test_torch_wide import (
    _mea_entry_points,
    _past_the_guard,
    _PastTheGuard,
    _viterbi_entry_points,
)
from test_torch_widths import (
    EXP_KW,
    THRESHOLD,
    _expectations_f32,
    _jparams,
    _modes,
    _packed,
    _params,
    _prepared,
    _valid_cells,
    width_pairs,
)

WIDER = (200, 256)  # dead lanes 200..255; none


@pytest.fixture(scope="module")
def pairs():
    return width_pairs()


@pytest.fixture(scope="module")
def layouts(pairs):
    """Per width: the padded batch and the JAX package's banded batch
    over the same diagonals."""
    out = {}
    for w in WIDER:
        pad = _packed(pairs, w, padded_width(w))
        out[w] = {
            "pad": pad,
            "jax": prepare_banded_batch(pairs, band_width=w,
                                        k_max=pad[0]["k_pad"]),
        }
    return out


# ---- the layout ---------------------------------------------------------- #

@pytest.mark.parametrize("w", WIDER)
def test_packed_codes_are_jax_codes_then_sentinel_lanes(pairs, layouts, w):
    prep, xyc, _, _ = layouts[w]["pad"]
    assert padded_width(w) == 256 and prep["W"] == 256
    assert prep["band_width"] == w
    codes = xyc.numpy().view(np.uint8)
    B, k_pad = len(pairs), prep["k_pad"]
    assert codes.shape == (B, k_pad, 256)
    host = untile(pack_pallas_pairs(pairs, _jparams(), band_width=w,
                                    k_max=k_pad)["xyc"], B).view(np.uint8)
    np.testing.assert_array_equal(codes[:, :, :w], host)
    np.testing.assert_array_equal(
        prep["offsets"], np.asarray(layouts[w]["jax"].offsets))
    dead = codes[:, :, w:]
    assert dead.shape[2] == 256 - w
    assert (dead & 0x3F == SENT).all()
    assert (dead & 0xC0 == codes[:, :, :1] & 0xC0).all()
    disp = dispatch.prepared_from_pairs({"device": "cpu"}, pairs, _params(),
                                        band_width=w, k_max=k_pad,
                                        exact_k=True)
    assert disp.batch.band_width == w
    assert torch.equal(disp.xyc, xyc)


def test_pack_kernel_model_at_256_matches_the_plain_pack():
    """csrc/pack.cu at W = 256, whose band is as wide as its chunk of 256
    diagonals: the numpy model of its buffers (each lookup inside what
    its chunk wrote) byte for byte the plain pack on random bytes over
    four chunks, reads shorter than one, across chunks and past k_pad."""
    rng = np.random.default_rng(256)
    B, W, k_pad = 6, 256, 896
    stream = rng.integers(0, 256, (B, k_pad)).astype(np.uint8)
    stream[1] &= 0xBF  # never shifts: Y alone
    stream[2] |= 0x40  # always shifts: X alone
    initx = rng.integers(0, 256, (B, W)).astype(np.uint8)
    m = np.array([40, 300, k_pad + 50, 0, 7, k_pad // 2], np.int32)
    n = np.array([90, k_pad + 9, 60, 5, 0, k_pad // 2], np.int32)
    np.testing.assert_array_equal(_scan_lookup_pack(stream, initx, m, n),
                                  _plain(stream, initx, m, n))


def test_padded_layout_gives_the_unpadded_bits_at_200(pairs, layouts):
    """Each output's live lanes are the unpadded band's, bit for bit;
    the dead lanes hold DIR_NONE in the direction codes and 0 in the
    gamma band and the flush."""
    w = 200
    bare = _packed(pairs, w)
    assert torch.equal(layouts[w]["pad"][1][:, :, :w], bare[1])
    got = _modes(layouts[w]["pad"], w)
    want = _modes(bare)
    for mode in got:
        for key, a in got[mode].items():
            if key in ("dirs", "gamma", "bp", "flush"):
                a = a[:, :, :w]
            assert torch.equal(a, want[mode][key]), (mode, key)
    assert (got["decode"]["dirs"][:, :, w:] == DIR_NONE).all()
    assert (got["decode"]["gamma"][:, :, w:] == 0).all()
    assert (got["gamma"]["gamma"][:, :, w:] == 0).all()
    assert (got["exp"]["flush"][:, :, w:] == 0).all()


# ---- against the JAX package's XLA scan at the same width ---------------- #

@pytest.mark.parametrize("w", WIDER)
def test_realign_matches_jax_realign_fused(pairs, layouts, w):
    batch = layouts[w]["jax"]
    want = realign_fused(batch, _jparams(), segment_size=8)
    prep, xyc, m, n = layouts[w]["pad"]
    got = realign_decode(xyc, m, n, _params(), band_width=w)
    np.testing.assert_allclose(got["loglik"].numpy(),
                               np.asarray(want["loglik"]), rtol=1e-5)
    cigars = rle_ops_batch(mea_walk(got["dirs"], xyc, m, n).numpy())
    offsets = np.asarray(batch.offsets)
    want_dirs = np.asarray(want["dirs"])
    for b, (x, y, _) in enumerate(pairs):
        assert cigars[b] == mea_traceback_fwd(want_dirs[b], offsets[b],
                                              len(y), len(x))


@pytest.mark.parametrize("w", WIDER)
def test_gamma_band_matches_forward_backward(pairs, layouts, w):
    batch = layouts[w]["jax"]
    fb = forward_backward(batch, _jparams())
    want = np.asarray(fb["gamma_match"])
    prep, xyc, m, n = layouts[w]["pad"]
    got = realign_gamma(xyc, m, n, _params(), band_width=w)
    np.testing.assert_allclose(got["loglik"].numpy(),
                               np.asarray(fb["loglik"]), rtol=1e-5)
    band = got["gamma"].numpy()[:, :, :w]
    offsets = np.asarray(batch.offsets)
    K1 = want.shape[1]
    for b, (x, y, _) in enumerate(pairs):
        valid = _valid_cells(offsets[b], K1, w, len(y), len(x))
        assert np.abs(band[b][:K1][valid] - want[b][valid]).max() <= 5e-5


@pytest.mark.parametrize("w", WIDER)
def test_retire_rows_and_flush_match_the_xla_retire_scan(pairs, layouts, w):
    batch = layouts[w]["jax"]
    fb = forward_backward(batch, _jparams())
    want = jax_post.posterior_expectations_batch(
        fb["gamma_match"], batch.yc, np.asarray(batch.offsets),
        np.asarray(batch.n), threshold=THRESHOLD)
    prepared = _prepared(pairs, w, EXP_KW,
                         prepared_cls=dispatch.PreparedPosteriors)
    assert prepared.xyc.shape[2] == 256
    out = prepared.run()  # ret and the flush sliced to the live width
    assert out["flush"].shape[2] == w
    lite = prepared.batch
    got = _expectations_f32(out["ret"], out["flush"], lite.offsets, lite.n,
                            w)
    for g, e in zip(got, want):
        assert g.shape == e.shape
        assert np.abs(g - e).max() <= 5e-5


@pytest.mark.parametrize("w", WIDER)
def test_em_sums_match_em_expectations(pairs, w):
    prepared = _prepared(pairs, w, {}, prepared_cls=dispatch.PreparedEm)
    assert prepared.xyc.shape[2] == 256
    got = prepared.run(_params())
    batch = prepare_banded_batch(pairs, band_width=w,
                                 k_max=prepared.xyc.shape[1])
    want = em_expectations(batch, _jparams(), segment_size=8)
    np.testing.assert_allclose(got["loglik"].numpy(),
                               np.asarray(want["loglik"]), rtol=1e-5)
    for key in ("trans", "emis"):
        e = np.asarray(want[key]).reshape(len(pairs), -1)
        g = got[key].numpy().reshape(len(pairs), -1)
        assert (np.abs(g - e).max(axis=1) / np.abs(e).max(axis=1)).max() \
            <= 3e-5, key


def test_em_train_matches_jax_em_train_at_200():
    pairs = _global_pairs(count=4)
    opts = dict(trials=1, iterations=2, band_width=200, seed=3, window_pad=32)
    got = port_em.em_train(pairs, port_em.EmOptions(batch_size=8, **opts),
                           device="cpu")
    want = jax_em.em_train(pairs, jax_em.EmOptions(use_mesh=False, **opts))
    np.testing.assert_allclose(got.running_likelihoods[0],
                               want.running_likelihoods[0], rtol=1e-5)
    np.testing.assert_allclose(got.model.transitions, want.model.transitions,
                               rtol=3e-5)
    np.testing.assert_allclose(got.model.emissions, want.model.emissions,
                               rtol=3e-5)


def test_realign_sam_file_matches_jax_at_200(mapped):  # noqa: F811
    d = mapped["dir"]
    jax_realign.realign_sam_file(
        mapped["sam"], str(d / "j_w200.sam"), mapped["fq"], mapped["fa"],
        band_width=200)
    port_realign_stage.realign_sam_file(
        mapped["sam"], str(d / "p_w200.sam"), mapped["fq"], mapped["fa"],
        band_width=200, device="cpu")
    got = sam_records(str(d / "p_w200.sam"))
    assert len(got) == 8
    assert got == sam_records(str(d / "j_w200.sam"))


# ---- the EM mode's lane sums and the decode's plan at W = 256 ------------ #

def test_lane_total_at_256_is_the_pairs_cross_add_then_one_warps_butterfly():
    """At W = 256 the EM sums lie in 64 lanes of 4 cells (the kernel's
    two warps of 32), and the plain butterfly's first step, lane l plus
    lane l ^ 32, is the kernel's add across the warps; the result is bit
    for bit that add followed by one warp's butterfly (16, 8, 4, 2, 1),
    and not a 32-lane butterfly over 8 cells a lane."""
    assert em_lanes(256) == 64 and em_lanes(128) == 32
    assert em_lanes(512) == 128 and em_lanes(8) == 8
    rng = np.random.default_rng(64)
    acc = (rng.standard_normal((3, 57, 64))
           * 10.0 ** rng.uniform(-6, 6, (3, 57, 64))).astype(np.float32)
    got = port_realign._lane_total(torch.from_numpy(acc))
    pair = torch.from_numpy(acc[..., :32]) + torch.from_numpy(acc[..., 32:])
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        pair = pair + pair[..., lanes ^ off]
    assert torch.equal(got, pair[..., 0])
    # the 32-lane layout (lane l owning cells 8l .. 8l + 7) sums otherwise
    cells = torch.from_numpy(acc).reshape(3, 57, 32, 2)
    other = port_realign._lane_total(cells[..., 0] + cells[..., 1])
    assert not torch.equal(got, other)


def test_decode_plan_splits_the_mapping_batch_into_four_at_256():
    """chip_smoke.py's mapping batch (512 reads, m + n of ~9,750 and up
    to its k_pad of 10,240) at W = 256: each read's decode slot (~5.9 KB
    a diagonal, ~58 MB a read) fits the 8 GiB cap, the batch four
    launches of whole reads, each within the cap."""
    rng = np.random.default_rng(9)
    m = rng.integers(4700, 5000, 512)
    n = rng.integers(9_500, 10_240, 512) - m
    n[0] = 10_240 - m[0]
    cap = port_realign.WORKSPACE_BYTES
    offsets, launches = port_realign.workspace_plan(
        m, n, 256, cap, port_realign.DECODE)
    assert len(launches) == 4 and launches[0][0] == 0
    assert launches[-1][1] == 512
    for (r0, r1), (s0, _) in zip(launches, launches[1:]):
        assert r1 == s0
    for r0, r1 in launches:
        assert offsets[r1] - offsets[r0] <= cap
    per_read = port_realign.read_workspace_bytes(10_240, 256,
                                                 port_realign.DECODE)
    assert 55e6 < per_read < 65e6
    assert port_realign.max_workspace_k(256, port_realign.DECODE) > 10_240


# ---- the width guard (ROADMAP C10, C11), without a card ------------------ #

@pytest.mark.parametrize("w", [129, 200, 256])
def test_mea_entry_points_take_129_to_256_past_the_guard(
        mapped, tmp_path, monkeypatch, w):  # noqa: F811
    monkeypatch.setattr(port_realign_stage, "chain_sam_file",
                        _past_the_guard)
    check_band_width(w, "cuda")
    for name, call in _mea_entry_points(mapped, tmp_path, w).items():
        with pytest.raises((ValueError, _PastTheGuard)) as err:
            call()
        assert "C10" not in str(err.value), name
        assert "C11" not in str(err.value), name
        if err.type is ValueError:
            assert "unsupported device" in str(err.value), name


def viterbi_entry_points_take(w, monkeypatch):
    """Each Viterbi entry point (``MappingEngine(decode="viterbi")``,
    ``PreparedViterbi``, ``PreparedForward``) takes w past the guard, to
    the device check (``meta``: ``unsupported device``; ``None`` without
    a card: no CUDA device) or to the stand-in pack and index build."""
    monkeypatch.setattr(dispatch, "pack_stream_pairs", _past_the_guard)
    monkeypatch.setattr("nanopore_tpu_torch.mapping.engine.KmerIndex.build",
                        _past_the_guard)
    for name, call in _viterbi_entry_points(w).items():
        with pytest.raises((ValueError, RuntimeError, _PastTheGuard)) as err:
            call()
        assert "C1" not in str(err.value), name
        if err.type is ValueError:
            assert "unsupported device" in str(err.value), name
        elif err.type is RuntimeError:
            assert "no CUDA device" in str(err.value), name
    for device in ("cuda", None, "cpu"):
        check_band_width(w, device)


@pytest.mark.parametrize("w", [129, 200, 256])
def test_viterbi_entry_points_take_129_to_256_past_the_guard(monkeypatch, w):
    """The Viterbi path serves 129-256 on the card (since ROADMAP C11's
    second step; to 512 since its fourth): each of its entry points
    takes 129-256 past the guard."""
    viterbi_entry_points_take(w, monkeypatch)


@pytest.mark.parametrize("path, w", [(None, 2049), (None, 4096),
                                     (None, 1), ("viterbi", 1025)])
def test_every_path_refuses_1_and_257_and_above_naming_c11(
        mapped, tmp_path, monkeypatch, path, w):  # noqa: F811
    """Every path (``path`` None) refuses 1, 2049 and 4096 on the card,
    and the Viterbi path's entry points alone (``path`` "viterbi") 1025,
    each entry point naming C11 before any work.  The name keeps the
    cases this test once held: the Viterbi path refused 257 and 300
    until ROADMAP C11's fourth step and 513 until its sixth, and the MEA
    path 257 until its third (both serve 257 to 1024 now:
    tests/test_torch_widest.py, tests/test_torch_widest_viterbi.py,
    tests/test_torch_w1024.py and tests/test_torch_w1024_viterbi.py, and
    the MEA path 1025 to 2048 since its seventh,
    tests/test_torch_w2048.py), so widths above the paths' top take
    their places."""
    monkeypatch.setattr(port_realign_stage, "chain_sam_file",
                        _past_the_guard)
    monkeypatch.setattr(dispatch, "pack_stream_pairs", _past_the_guard)
    calls = dict(_viterbi_entry_points(w))
    if path is None:
        calls.update(_mea_entry_points(mapped, tmp_path, w))
    for name, call in calls.items():
        with pytest.raises(ValueError, match="C11"):
            call()
    for device in ("cuda", None):
        with pytest.raises(ValueError, match="C11"):
            check_band_width(w, device)
    assert not (tmp_path / "out.sam").exists()
    assert not (tmp_path / "r").exists()


@pytest.mark.parametrize("w", [129, 200, 255, 256])
def test_padded_width_lays_129_to_256_into_256(w):
    assert padded_width(w) == 256
    assert padded_width(257) == 384  # the W = 384 layout (C11's third step)


def test_the_cpu_serves_300(pairs):
    """The CPU serves a band the card's Viterbi path does not (the case
    once used 300, which the W = 384 layout now takes): the MEA decode
    and the Viterbi at 600, laid into the W = 768 layout on either
    device (the card's MEA path serves it since ROADMAP C11's fifth
    step), against the JAX package's XLA scans at the same width."""
    w = 600
    pairs = pairs[:2]
    rea = _prepared(pairs, w, {})
    assert rea.xyc.shape[2] == padded_width(w) == 768
    loglik, cigars, _ = rea.decode()
    batch = prepare_banded_batch(pairs, band_width=w, k_max=rea.xyc.shape[1])
    want = realign_fused(batch, _jparams(), segment_size=8)
    np.testing.assert_allclose(loglik, np.asarray(want["loglik"]), rtol=1e-5)
    offsets = np.asarray(batch.offsets)
    for b, (x, y, _) in enumerate(pairs):
        assert cigars[b] == mea_traceback_fwd(
            np.asarray(want["dirs"])[b], offsets[b], len(y), len(x))
    vit = _prepared(pairs, w, {}, prepared_cls=dispatch.PreparedViterbi)
    out = vit.run()
    scores, fstates, bps = viterbi_decode_batch(batch, _jparams())
    np.testing.assert_allclose(out["score"].numpy(), np.asarray(scores),
                               rtol=1e-5)
    ops, end = viterbi_walk(out["bp"], vit.xyc, vit.m, vit.n, out["fstate"])
    assert not end.any()
    for b, (x, y, _) in enumerate(pairs):
        assert rle_ops_batch(ops.numpy())[b] == viterbi_traceback(
            np.asarray(bps)[b], offsets[b], len(y), len(x),
            int(np.asarray(fstates)[b]))
