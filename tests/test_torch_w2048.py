"""Band widths 1025 to 2048 in the port's W = 1536 and W = 2048 layouts
(the MEA path), on the CPU, against the JAX package's XLA-scan route at
the same width.

A band of live width 1024 < w <= 1536 lies in the first w lanes of
W = 1536 lanes, and 1536 < w <= 2048 in W = 2048
(``ops.pack.padded_width``), its dead lanes all sentinel, on either
device.  On the card the MEA path's kernels serve these widths: the
pack, the MEA walker (chunks of 32 diagonals), and the realign kernel's
five modes with a read's band on a thread-block cluster of two blocks
of six or eight warps (csrc/group.cuh's cluster tier).  On the first
two of ``width_pairs()``' reads (a pure match, a long deletion):

* the packed codes at w = 1100 and 2048: lanes < w those of the JAX
  package's packs at w, lanes >= w the sentinel with the row's bits
  6-7; and a numpy model of csrc/pack.cu's chunks at W = 1536 and 2048
  (a buffer's head of W symbols reaching six and eight chunks of 256
  back) byte for byte the plain pack;
* against the JAX package at w = 1100 and 2048: realign loglik <= 1e-5
  relative with identical MEA cigars (``realign_fused``); the gamma
  band <= 5e-5 (``forward_backward``); the retire rows and flush <= 5e-5
  (the XLA retire scan); EM sums within 3e-5 of each table's largest
  entry (``em_expectations``);
* at w = 1100 and 1800, every realign mode in the padded layout gives,
  bit for bit in the live lanes, what the plain versions give on the
  unpadded band;
* the kernels' own rules: the EM mode's lane sums over the cluster's 12
  and 16 warps (block 1's warps onto block 0's, then the six- and
  eight-warp folds of W = 768 and 1024, then one warp's butterfly) in a
  numpy model; ``em_width`` lays 1025-1536 into 1536 and 1537-2048 into
  2048; the workspace plan of the card's mapping batch at W = 2048
  (every mode in the EM mode's slot: ~26 launches under the 8 GiB cap),
  each read within ``max_workspace_k``;
* the width guard without a card: every entry point of the MEA path
  takes 1025, 1536 and 2048 past the guard and refuses 2049 naming C11
  (tests/test_torch_w1024_viterbi.py holds the Viterbi path's refusal
  of 1025).
"""

import numpy as np
import pytest
import torch

from nanopore_tpu.ops import posteriors as jax_post
from nanopore_tpu.ops.mea import mea_traceback_fwd, realign_fused
from nanopore_tpu.ops.pairhmm import em_expectations, forward_backward
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu.ops.pairhmm_pallas_realign import pack_pallas_pairs
from nanopore_tpu_torch.align import realign as port_realign_stage
from nanopore_tpu_torch.ops import dispatch
from nanopore_tpu_torch.ops import realign as port_realign
from nanopore_tpu_torch.ops.pack import (
    MEA,
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
from nanopore_tpu_torch.ops.traceback import mea_walk, rle_ops_batch
from test_torch_chain_realign import mapped  # noqa: F401
from test_torch_pack import _plain, _scan_lookup_pack
from test_torch_w1024 import _warp_fold
from test_torch_wide import (
    _mea_entry_points,
    _past_the_guard,
    _PastTheGuard,
    _viterbi_entry_points,
)
from test_torch_wider_viterbi import one_thread  # noqa: F401
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

W2048 = (1100, 2048)  # dead lanes in W = 1536; none in 2048
PADDED = (1100, 1800)  # dead lanes in W = 1536 and in 2048


@pytest.fixture(scope="module")
def pairs():
    return width_pairs()[:2]


@pytest.fixture(scope="module")
def layouts(pairs):
    """Per width: the padded batch, the JAX package's banded batch over
    the same diagonals and its ``forward_backward`` (the gamma band's
    and the retire scan's reference)."""
    out = {}
    for w in W2048:
        pad = _packed(pairs, w, padded_width(w))
        batch = prepare_banded_batch(pairs, band_width=w,
                                     k_max=pad[0]["k_pad"])
        out[w] = {"pad": pad, "jax": batch,
                  "fb": forward_backward(batch, _jparams())}
    return out


# ---- the layout ---------------------------------------------------------- #

@pytest.mark.parametrize("w", W2048)
def test_packed_codes_are_jax_codes_then_sentinel_lanes(pairs, layouts, w):
    prep, xyc, _, _ = layouts[w]["pad"]
    W = 1536 if w <= 1536 else 2048
    assert padded_width(w) == W and prep["W"] == W
    assert prep["band_width"] == w
    codes = xyc.numpy().view(np.uint8)
    B, k_pad = len(pairs), prep["k_pad"]
    assert codes.shape == (B, k_pad, W)
    host = untile(pack_pallas_pairs(pairs, _jparams(), band_width=w,
                                    k_max=k_pad)["xyc"], B).view(np.uint8)
    np.testing.assert_array_equal(codes[:, :, :w], host)
    np.testing.assert_array_equal(
        prep["offsets"], np.asarray(layouts[w]["jax"].offsets))
    dead = codes[:, :, w:]
    assert dead.shape[2] == W - w
    assert (dead & 0x3F == SENT).all()
    assert (dead & 0xC0 == codes[:, :, :1] & 0xC0).all()
    disp = dispatch.prepared_from_pairs({"device": "cpu"}, pairs, _params(),
                                        band_width=w, k_max=k_pad,
                                        exact_k=True)
    assert disp.batch.band_width == w
    assert torch.equal(disp.xyc, xyc)


@pytest.mark.parametrize("W", [1536, 2048])
def test_pack_kernel_model_wider_than_six_chunks_matches_the_plain_pack(
        W):
    """csrc/pack.cu at W = 1536 and 2048, bands six and eight times its
    chunk of 256 diagonals, so a buffer's head of W symbols, copied from
    the last chunk's buffer, reaches back six or eight chunks: the numpy
    model of its buffers (each lookup inside what its chunk and its head
    wrote) byte for byte the plain pack on random bytes over ten chunks,
    reads shorter than one, across chunks and past k_pad."""
    rng = np.random.default_rng(W)
    B, k_pad = 5, 2560
    stream = rng.integers(0, 256, (B, k_pad)).astype(np.uint8)
    stream[1] &= 0xBF  # never shifts: Y alone
    stream[2] |= 0x40  # always shifts: X alone
    initx = rng.integers(0, 256, (B, W)).astype(np.uint8)
    m = np.array([40, 300, k_pad + 50, 7, k_pad // 2], np.int32)
    n = np.array([90, k_pad + 9, 60, 0, k_pad // 2], np.int32)
    np.testing.assert_array_equal(_scan_lookup_pack(stream, initx, m, n),
                                  _plain(stream, initx, m, n))


@pytest.mark.parametrize("w", PADDED)
def test_padded_layout_gives_the_unpadded_bits(pairs, w):
    """Each output's live lanes are the unpadded band's, bit for bit;
    the dead lanes hold DIR_NONE in the direction codes and 0 in the
    gamma band and the flush.  (The plain EM mode lays the unpadded band
    into the kernel's layout too: ``ops.realign.em_width``.)"""
    pad = _packed(pairs, w, padded_width(w))
    bare = _packed(pairs, w)
    assert torch.equal(pad[1][:, :, :w], bare[1])
    got = _modes(pad, w)
    want = _modes(bare)
    for mode in ("decode", "gamma", "exp", "em"):
        for key, a in got[mode].items():
            if key in ("dirs", "gamma", "flush"):
                a = a[:, :, :w]
            assert torch.equal(a, want[mode][key]), (mode, key)
    assert (got["decode"]["dirs"][:, :, w:] == DIR_NONE).all()
    assert (got["decode"]["gamma"][:, :, w:] == 0).all()
    assert (got["gamma"]["gamma"][:, :, w:] == 0).all()
    assert (got["exp"]["flush"][:, :, w:] == 0).all()


# ---- against the JAX package's XLA scan at the same width ---------------- #

@pytest.mark.parametrize("w", W2048)
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


@pytest.mark.parametrize("w", W2048)
def test_gamma_band_matches_forward_backward(pairs, layouts, w):
    batch, fb = layouts[w]["jax"], layouts[w]["fb"]
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


@pytest.mark.parametrize("w", W2048)
def test_retire_rows_and_flush_match_the_xla_retire_scan(pairs, layouts, w):
    batch, fb = layouts[w]["jax"], layouts[w]["fb"]
    want = jax_post.posterior_expectations_batch(
        fb["gamma_match"], batch.yc, np.asarray(batch.offsets),
        np.asarray(batch.n), threshold=THRESHOLD)
    prepared = _prepared(pairs, w, EXP_KW,
                         prepared_cls=dispatch.PreparedPosteriors)
    assert prepared.xyc.shape[2] == padded_width(w)
    out = prepared.run()  # ret and the flush sliced to the live width
    assert out["flush"].shape[2] == w
    lite = prepared.batch
    got = _expectations_f32(out["ret"], out["flush"], lite.offsets, lite.n,
                            w)
    for g, e in zip(got, want):
        assert g.shape == e.shape
        assert np.abs(g - e).max() <= 5e-5


@pytest.mark.parametrize("w", W2048)
def test_em_sums_match_em_expectations(pairs, w):
    prepared = _prepared(pairs, w, {}, prepared_cls=dispatch.PreparedEm)
    assert prepared.xyc.shape[2] == padded_width(w)
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


# ---- the kernels' own rules at W = 1536 and 2048 ------------------------- #

@pytest.mark.parametrize("W", [1536, 2048])
def test_lane_total_folds_block_1_onto_block_0_then_one_blocks_warps(W):
    """The EM sums lie in W / 4 lanes of 4 cells: the cluster's two
    blocks of G = W / 256 warps (12 and 16 warps in all).  The fold's
    first step (h = 6 or 8) adds block 1's warp i onto block 0's warp i,
    lane for lane (csrc/realign.cu reads block 1's sums through
    distributed shared memory); block 0 then folds its G warps as the
    W = 768 and 1024 builds do, then one warp's butterfly.
    ``_lane_total`` is the numpy model of that order bit for bit."""
    G = W // 256
    assert em_lanes(W) == 2 * 32 * G
    rng = np.random.default_rng(W)
    acc = (rng.standard_normal((3, 57, 64 * G))
           * 10.0 ** rng.uniform(-6, 6, (3, 57, 64 * G))).astype(np.float32)
    got = port_realign._lane_total(torch.from_numpy(acc)).numpy()
    assert np.array_equal(got, _warp_fold(acc, 2 * G))
    # block 1 onto block 0, then the one-block fold of G warps
    block0, block1 = acc[..., :32 * G], acc[..., 32 * G:]
    assert np.array_equal(got, _warp_fold(block0 + block1, G))
    # the two blocks summed otherwise (each folded alone, then added)
    # round differently
    apart = _warp_fold(block0, G) + _warp_fold(block1, G)
    assert not np.array_equal(got, apart)


def test_em_width_lays_1025_to_1536_into_1536_and_up_to_2048_into_2048():
    assert [port_realign.em_width(w) for w in (1024, 1025, 1100, 1536,
                                               1537, 1800, 2048, 2049)] == [
        1024, 1536, 1536, 1536, 2048, 2048, 2048, 4096]
    assert [em_lanes(port_realign.em_width(w)) for w in (1100, 1800)] == [
        384, 512]


def test_decode_plan_fits_the_mapping_batch_at_2048_in_its_launches():
    """chip_smoke.py's mapping batch (512 reads, m + n of ~9,750 and up
    to its k_pad of 10,240) at W = 2048: every mode keeps the EM mode's
    slot (kq x 5 x W f32 states, the whole band's, and the rescale
    inverses), ~420 MB a read, so the 8 GiB cap takes ~26 launches of
    whole reads, ~20 reads each, each within the cap and each read
    within ``max_workspace_k``."""
    rng = np.random.default_rng(9)
    m = rng.integers(4700, 5000, 512)
    n = rng.integers(9_500, 10_240, 512) - m
    n[0] = 10_240 - m[0]
    cap = port_realign.WORKSPACE_BYTES
    kq = 10_240
    for mode in (port_realign.DECODE, port_realign.DECODE_GAMMA,
                 port_realign.GAMMA, port_realign.EXP, port_realign.EM):
        assert port_realign.read_workspace_bytes(kq, 2048, mode) == (
            kq * 5 * 2048 * 4 + (kq + 4) // 4 * 16)
    assert port_realign.two_phase(1536) and port_realign.two_phase(2048)
    assert port_realign.CLUSTER_WIDTHS == (1536, 2048)
    offsets, launches = port_realign.workspace_plan(
        m, n, 2048, cap, port_realign.DECODE)
    assert 24 <= len(launches) <= 27
    assert all(19 <= r1 - r0 <= 22 for r0, r1 in launches[:-1])
    assert launches[0][0] == 0 and launches[-1][1] == 512
    for (r0, r1), (s0, _) in zip(launches, launches[1:]):
        assert r1 == s0
        assert offsets[r1 + 1] - offsets[r0] > cap  # the next read would not fit
    for r0, r1 in launches:
        assert offsets[r1] - offsets[r0] <= cap
    k_max = port_realign.max_workspace_k(2048, port_realign.DECODE)
    assert (m + n).max() <= k_max
    assert port_realign.read_workspace_bytes(k_max, 2048,
                                             port_realign.DECODE) <= cap
    assert port_realign.read_workspace_bytes(k_max + 2, 2048,
                                             port_realign.DECODE) > cap


# ---- the width guard (ROADMAP C10, C11), without a card ------------------ #

@pytest.mark.parametrize("w", [1025, 1536, 2048])
def test_mea_entry_points_take_1025_to_2048_past_the_guard(
        mapped, tmp_path, monkeypatch, w):  # noqa: F811
    monkeypatch.setattr(port_realign_stage, "chain_sam_file",
                        _past_the_guard)
    check_band_width(w, "cuda", MEA)
    assert padded_width(w) == (1536 if w <= 1536 else 2048)
    for name, call in _mea_entry_points(mapped, tmp_path, w).items():
        with pytest.raises((ValueError, _PastTheGuard)) as err:
            call()
        assert "C10" not in str(err.value), name
        assert "C11" not in str(err.value), name
        if err.type is ValueError:
            assert "unsupported device" in str(err.value), name


def test_the_mea_path_refuses_2049_naming_c11(mapped, tmp_path,
                                              monkeypatch):  # noqa: F811
    """Above 2048 every MEA entry point refuses the band on the card
    before any work (no chain, no pack), naming C11, and the message
    gives each path's top; the Viterbi path's entry points refuse 2049
    too (their top is 1024); the CPU serves it, in its own width."""
    monkeypatch.setattr(port_realign_stage, "chain_sam_file",
                        _past_the_guard)
    monkeypatch.setattr(dispatch, "pack_stream_pairs", _past_the_guard)
    calls = dict(_mea_entry_points(mapped, tmp_path, 2049),
                 **_viterbi_entry_points(2049))
    for name, call in calls.items():
        with pytest.raises(ValueError, match="C11") as err:
            call()
        assert ("the MEA path's kernels take widths 2 to 2048 and the "
                "Viterbi path's 2 to 1024") in str(err.value), name
    for device in ("cuda", None):
        with pytest.raises(ValueError, match="C11"):
            check_band_width(2049, device, MEA)
    check_band_width(2049, "cpu", MEA)
    assert padded_width(2049) == 2049
    assert not (tmp_path / "out.sam").exists()
    assert not (tmp_path / "r").exists()
