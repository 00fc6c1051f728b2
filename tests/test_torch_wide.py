"""Band widths 65 to 128 in the port's W = 128 layout (the MEA path),
on the CPU, against the JAX package's XLA-scan route at the same width.

A band of live width 64 < w <= 128 lies in the first w lanes of W = 128
lanes (``ops.pack.padded_width``), its dead lanes all sentinel, on
either device, as tests/test_torch_widths.py holds the W = 32 and W = 64
layouts.  On the card every kernel (pack, realign in every mode, both
walkers, the Viterbi and the forward-only kernel) serves these widths;
tests/test_torch_wide_viterbi.py holds the Viterbi path at them.  At
w = 96 (dead lanes) and w = 128 (none):

* the packed codes: lanes < w those of the JAX package's packs at w,
  lanes >= w the sentinel with the row's bits 6-7;
* every realign mode (decode, decode + gamma, gamma, exp, EM), and on
  the CPU the forward-only loglik and the Viterbi, in the padded layout
  give, bit for bit in the live lanes, what the plain versions give on
  the unpadded band of width w;
* against the JAX package at w: realign loglik <= 1e-5 relative with
  identical MEA cigars (``realign_fused``); the gamma band <= 5e-5
  (``forward_backward``); the retire rows and flush <= 5e-5
  (``expectation_streams``); EM sums within 3e-5 of each table's largest
  entry (``em_expectations``);
* at w = 96: ``em_train`` (models within 3e-5 relative),
  ``realign_sam_file`` (records equal), ``MappingEngine(decode="mea")``
  (records equal to the JAX engine's), and on random codes no MEA op
  leaving the live band, every dead lane's direction code DIR_NONE;
* the width guard without a card: every entry point of the MEA, the
  Viterbi and the forward-only paths takes 65..128 past the guard; at
  1 every path refuses naming C10 before any work, and every path takes
  129 and 160 past the guard (since ROADMAP C11's first step the MEA
  path, since its second the Viterbi path: tests/test_torch_wider.py);
  the CPU serves 160, laid into 256 lanes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nanopore_tpu.align import em as jax_em
from nanopore_tpu.align import realign as jax_realign
from nanopore_tpu.io.seqio import read_fasta_dict as jax_read_fasta_dict
from nanopore_tpu.mapping.engine import MappingEngine as JaxEngine
from nanopore_tpu.mapping.presets import MAPPER_REGISTRY as JAX_PRESETS
from nanopore_tpu.ops import posteriors as jax_post
from nanopore_tpu.ops.mea import mea_traceback_fwd, realign_fused
from nanopore_tpu.ops.pairhmm import em_expectations, forward_backward
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu.ops.pairhmm_pallas_realign import (
    pack_pallas_pairs,
    prepare_pallas_realign,
)
from nanopore_tpu.ops.viterbi import viterbi_decode_batch, viterbi_traceback
from nanopore_tpu_torch import cli
from nanopore_tpu_torch.align import em as port_em
from nanopore_tpu_torch.align import realign as port_realign_stage
from nanopore_tpu_torch.io.sam import CIG, SamRecord
from nanopore_tpu_torch.io.seqio import read_fasta_dict
from nanopore_tpu_torch.mapping.engine import MapperConfig, MappingEngine
from nanopore_tpu_torch.mapping.presets import MAPPER_REGISTRY
from nanopore_tpu_torch.ops import dispatch
from nanopore_tpu_torch.ops.pack import SENT, padded_width
from nanopore_tpu_torch.ops import realign as port_realign
from nanopore_tpu_torch.ops.realign import (
    DIR_NONE,
    realign_decode,
    realign_gamma,
    untile,
)
from nanopore_tpu_torch.ops.traceback import (
    mea_walk,
    rle_ops_batch,
    viterbi_walk,
)
from nanopore_tpu_torch.scripts import rescue_2d
from test_torch_chain_realign import (  # noqa: F401
    mapped,
    sam_records,
    write_small_inputs,
)
from test_torch_em import _global_pairs
from test_torch_widths import (
    EXP_KW,
    THRESHOLD,
    _expectations_f32,
    _jparams,
    _lanes_walked,
    _modes,
    _packed,
    _params,
    _prepared,
    _valid_cells,
    width_pairs,
)

WIDE = (96, 128)  # dead lanes 96..127; none


@pytest.fixture(scope="module")
def pairs():
    return width_pairs()


@pytest.fixture(scope="module")
def layouts(pairs):
    """Per width: the padded batch, the unpadded one, and the JAX
    package's banded batch over the same diagonals."""
    out = {}
    for w in WIDE:
        pad = _packed(pairs, w, padded_width(w))
        k_pad = pad[0]["k_pad"]
        out[w] = {
            "pad": pad,
            "bare": _packed(pairs, w),
            "jax": prepare_banded_batch(pairs, band_width=w, k_max=k_pad),
        }
    return out


# ---- the layout ---------------------------------------------------------- #

@pytest.mark.parametrize("w", WIDE)
def test_packed_codes_are_jax_codes_then_sentinel_lanes(pairs, layouts, w):
    prep, xyc, _, _ = layouts[w]["pad"]
    assert padded_width(w) == 128 and prep["W"] == 128
    assert prep["band_width"] == w
    codes = xyc.numpy().view(np.uint8)
    B, k_pad = len(pairs), prep["k_pad"]
    assert codes.shape == (B, k_pad, 128)
    jp = _jparams()
    host = untile(pack_pallas_pairs(pairs, jp, band_width=w,
                                    k_max=k_pad)["xyc"], B).view(np.uint8)
    np.testing.assert_array_equal(codes[:, :, :w], host)
    repacked = prepare_pallas_realign(layouts[w]["jax"], jp)
    np.testing.assert_array_equal(
        codes[:, :, :w], untile(repacked["xyc"], B).view(np.uint8)[:, :k_pad])
    np.testing.assert_array_equal(
        prep["offsets"], np.asarray(layouts[w]["jax"].offsets))
    dead = codes[:, :, w:]
    assert dead.shape[2] == 128 - w
    assert (dead & 0x3F == SENT).all()
    assert (dead & 0xC0 == codes[:, :, :1] & 0xC0).all()
    disp = dispatch.prepared_from_pairs({"device": "cpu"}, pairs, _params(),
                                        band_width=w, k_max=k_pad,
                                        exact_k=True)
    assert disp.batch.band_width == w
    assert torch.equal(disp.xyc, xyc)


@pytest.mark.parametrize("w", WIDE)
def test_padded_layout_gives_the_unpadded_bits(layouts, w):
    """Each output's live lanes are the unpadded band's, bit for bit;
    the dead lanes hold DIR_NONE in the direction codes and 0 in the
    gamma band and the flush."""
    assert torch.equal(layouts[w]["pad"][1][:, :, :w], layouts[w]["bare"][1])
    got = _modes(layouts[w]["pad"], w)
    want = _modes(layouts[w]["bare"])
    for mode in got:
        for key, a in got[mode].items():
            if key in ("dirs", "gamma", "bp", "flush"):
                a = a[:, :, :w]
            assert torch.equal(a, want[mode][key]), (mode, key)
    if w < 128:
        assert (got["decode"]["dirs"][:, :, w:] == DIR_NONE).all()
        assert (got["decode"]["gamma"][:, :, w:] == 0).all()
        assert (got["gamma"]["gamma"][:, :, w:] == 0).all()
        assert (got["exp"]["flush"][:, :, w:] == 0).all()


# ---- against the JAX package's XLA scan at the same width ---------------- #

@pytest.mark.parametrize("w", WIDE)
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


@pytest.mark.parametrize("w", WIDE)
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


@pytest.mark.parametrize("w", WIDE)
def test_retire_rows_and_flush_match_the_xla_retire_scan(pairs, layouts, w):
    batch = layouts[w]["jax"]
    fb = forward_backward(batch, _jparams())
    want = jax_post.posterior_expectations_batch(
        fb["gamma_match"], batch.yc, np.asarray(batch.offsets),
        np.asarray(batch.n), threshold=THRESHOLD)
    prepared = _prepared(pairs, w, EXP_KW,
                         prepared_cls=dispatch.PreparedPosteriors)
    assert prepared.xyc.shape[2] == 128
    out = prepared.run()  # ret and the flush sliced to the live width
    assert out["flush"].shape[2] == w
    lite = prepared.batch
    got = _expectations_f32(out["ret"], out["flush"], lite.offsets, lite.n,
                            w)
    for g, e in zip(got, want):
        assert g.shape == e.shape
        assert np.abs(g - e).max() <= 5e-5


@pytest.mark.parametrize("w", WIDE)
def test_em_sums_match_em_expectations(pairs, w):
    prepared = _prepared(pairs, w, {}, prepared_cls=dispatch.PreparedEm)
    assert prepared.xyc.shape[2] == 128
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


def test_em_train_matches_jax_em_train_at_96():
    pairs = _global_pairs(count=4)
    opts = dict(trials=1, iterations=2, band_width=96, seed=3, window_pad=32)
    got = port_em.em_train(pairs, port_em.EmOptions(batch_size=8, **opts),
                           device="cpu")
    want = jax_em.em_train(pairs, jax_em.EmOptions(use_mesh=False, **opts))
    np.testing.assert_allclose(got.running_likelihoods[0],
                               want.running_likelihoods[0], rtol=1e-5)
    np.testing.assert_allclose(got.model.transitions, want.model.transitions,
                               rtol=3e-5)
    np.testing.assert_allclose(got.model.emissions, want.model.emissions,
                               rtol=3e-5)


def test_realign_sam_file_matches_jax_at_96(mapped):  # noqa: F811
    d = mapped["dir"]
    jax_realign.realign_sam_file(
        mapped["sam"], str(d / "j_w96.sam"), mapped["fq"], mapped["fa"],
        band_width=96)
    port_realign_stage.realign_sam_file(
        mapped["sam"], str(d / "p_w96.sam"), mapped["fq"], mapped["fa"],
        band_width=96, device="cpu")
    got = sam_records(str(d / "p_w96.sam"))
    assert len(got) == 8
    assert got == sam_records(str(d / "j_w96.sam"))


def test_mea_engine_matches_the_jax_engine_at_96(tmp_path):
    """``MappingEngine(band_width=96, decode="mea")`` on the CPU: every
    record equal to the JAX engine's at the same width (its XLA scan)."""
    fa, fq = write_small_inputs(tmp_path, 3, n_reads=4)
    jax_sam, port_sam = str(tmp_path / "jax.sam"), str(tmp_path / "port.sam")
    JaxEngine(jax_read_fasta_dict(fa), dataclasses.replace(
        JAX_PRESETS["LastParams"].config, band_width=96)).map_fastq(
            fq, jax_sam)
    cfg = dataclasses.replace(MAPPER_REGISTRY["LastParams"].config,
                              band_width=96)
    assert cfg.decode == "mea"
    MappingEngine(read_fasta_dict(fa), cfg, device="cpu").map_fastq(
        fq, port_sam)
    got = sam_records(port_sam)
    assert len({r[0] for r in got}) == 4
    assert got == sam_records(jax_sam)


def test_no_mea_op_leaves_the_live_band_on_random_codes():
    """Unrelated random sequences under random guides at w = 96: the
    paths press on the band's edges, and the MEA decode leaves no lane
    of 0..95 of its 128; every dead lane's direction code is DIR_NONE."""
    rng = np.random.default_rng(96)
    w = 96
    pairs = []
    for _ in range(4):
        n, m = int(rng.integers(120, 220)), int(rng.integers(120, 220))
        d = int(rng.integers(0, min(n, m)))
        guide = [(CIG.M, d), (CIG.D, n - d), (CIG.I, m - d)]
        pairs.append((rng.integers(0, 5, n).astype(np.int8),
                      rng.integers(0, 5, m).astype(np.int8), guide))
    prep, xyc, m, n = _packed(pairs, w, padded_width(w))
    assert xyc.shape[2] == 128
    dec = realign_decode(xyc, m, n, _params(), band_width=w)
    assert (dec["dirs"][:, :, w:] == DIR_NONE).all()
    cigars = rle_ops_batch(mea_walk(dec["dirs"], xyc, m, n).numpy())
    for b, (x, y, _) in enumerate(pairs):
        lanes = _lanes_walked(cigars[b], prep["offsets"][b], len(y), len(x))
        assert lanes.min() >= 0 and lanes.max() < w


def test_decode_plan_splits_the_mapping_batch_in_two_at_128():
    """chip_smoke.py's mapping batch (512 reads, m + n of ~9,750 and up
    to its k_pad of 10,240) at W = 128: each read's decode slot (~2.95 KB
    a diagonal) fits the 8 GiB cap, the batch two launches of whole
    reads, each slot within its launch's workspace; every mode keeps
    its own slot size."""
    rng = np.random.default_rng(9)
    m = rng.integers(4700, 5000, 512)
    n = rng.integers(9_500, 10_240, 512) - m
    n[0] = 10_240 - m[0]
    cap = port_realign.WORKSPACE_BYTES
    offsets, launches = port_realign.workspace_plan(
        m, n, 128, cap, port_realign.DECODE)
    assert len(launches) == 2 and launches[0][0] == 0
    assert launches[-1][1] == 512 and launches[0][1] == launches[1][0]
    for r0, r1 in launches:
        assert offsets[r1] - offsets[r0] <= cap
    sizes = {mode: int(port_realign.read_workspace_bytes(10_240, 128, mode))
             for mode in range(5)}
    assert sizes[port_realign.DECODE] == sizes[port_realign.DECODE_GAMMA]
    assert sizes[port_realign.EM] == sizes[port_realign.EXP]
    assert sizes[port_realign.GAMMA] < sizes[port_realign.EM] \
        < sizes[port_realign.DECODE]
    assert port_realign.max_workspace_k(128, port_realign.DECODE) > 10_240


# ---- the width guard (ROADMAP C10), without a card ----------------------- #

class _PastTheGuard(Exception):
    """Raised by a stand-in for the first step after the width guard."""


def _past_the_guard(*args, **kwargs):
    raise _PastTheGuard()


def _recs():
    return [SamRecord(qname="q", flag=0, rname="chrT", pos=0, mapq=0,
                      cigar=[(CIG.M, 8)], seq="ACGTACGT")]


def _mea_entry_points(mapped, tmp_path, w):  # noqa: F811
    """Each MEA-path entry point at width ``w`` off the CPU, as a
    callable: the ``meta`` device stands in for the card, so a call the
    guard lets through stops at ``resolve_device`` (``unsupported
    device``) or at the stand-in chain (``_PastTheGuard``)."""
    small = width_pairs()[:2]
    return {
        "realign_records": lambda: port_realign_stage.realign_records(
            _recs(), {"chrT": "ACGTACGT"}, band_width=w, device="meta"),
        "realign_sam_file": lambda: port_realign_stage.realign_sam_file(
            mapped["sam"], str(tmp_path / "out.sam"), mapped["fq"],
            mapped["fa"], band_width=w),
        "cli realign": lambda: cli.main(
            ["realign", mapped["sam"], mapped["fq"], mapped["fa"],
             str(tmp_path / "cli.sam"), "--band-width", str(w)]),
        "em_train": lambda: port_em.em_train(
            _global_pairs(count=1), port_em.EmOptions(band_width=w),
            device="meta"),
        "rescue_2d": lambda: rescue_2d.rescue(
            "t.sam", "c.sam", "2d.sam", str(tmp_path), str(tmp_path / "r"),
            band_width=w, device="meta"),
        "MappingEngine(decode=mea)": lambda: MappingEngine(
            {"chrT": "ACGT" * 40}, MapperConfig(band_width=w),
            device="meta"),
        "PreparedRealign": lambda: dispatch.prepared_from_pairs(
            {"device": "meta"}, small, _params(), band_width=w),
        "PreparedEm": lambda: dispatch.prepared_from_pairs(
            {"device": "meta"}, small, _params(), band_width=w,
            prepared_cls=dispatch.PreparedEm),
        "PreparedPosteriors": lambda: dispatch.prepared_from_pairs(
            {"device": "meta"}, small, _params(), band_width=w,
            prepared_cls=dispatch.PreparedPosteriors),
    }


def _viterbi_entry_points(w):
    small = width_pairs()[:2]
    return {
        "MappingEngine(decode=viterbi)": lambda: MappingEngine(
            {"chrT": "ACGT" * 40}, MapperConfig(band_width=w,
                                                decode="viterbi"),
            device="meta"),
        "PreparedViterbi": lambda: dispatch.prepared_from_pairs(
            {"device": "meta"}, small, _params(), band_width=w,
            prepared_cls=dispatch.PreparedViterbi),
        "PreparedForward": lambda: dispatch.prepared_from_pairs(
            {"device": None}, small, _params(), band_width=w,
            prepared_cls=dispatch.PreparedForward),
    }


@pytest.mark.parametrize("w", [65, 96, 128])
def test_mea_entry_points_take_65_to_128_past_the_guard(
        mapped, tmp_path, monkeypatch, w):  # noqa: F811
    monkeypatch.setattr(port_realign_stage, "chain_sam_file",
                        _past_the_guard)
    for name, call in _mea_entry_points(mapped, tmp_path, w).items():
        with pytest.raises((ValueError, _PastTheGuard)) as err:
            call()
        assert "C10" not in str(err.value), name
        if err.type is ValueError:
            assert "unsupported device" in str(err.value), name


@pytest.mark.parametrize("w", [65, 96, 128])
def test_viterbi_paths_refuse_65_to_128_naming_c10(monkeypatch, w):
    """The Viterbi paths once refused these widths on the card (the
    name keeps the case); now they serve them (ROADMAP C10): each entry
    point takes 65, 96 and 128 past the guard, to the device check
    (``meta``: ``unsupported device``; ``None`` without a card: no CUDA
    device) or to the stand-in pack and index build."""
    monkeypatch.setattr(dispatch, "pack_stream_pairs", _past_the_guard)
    monkeypatch.setattr("nanopore_tpu_torch.mapping.engine.KmerIndex.build",
                        _past_the_guard)
    for name, call in _viterbi_entry_points(w).items():
        with pytest.raises((ValueError, RuntimeError, _PastTheGuard)) as err:
            call()
        assert "C10" not in str(err.value), name
        if err.type is ValueError:
            assert "unsupported device" in str(err.value), name
        elif err.type is RuntimeError:
            assert "no CUDA device" in str(err.value), name


@pytest.mark.parametrize("w", [1, 129, 160])
def test_every_path_refuses_widths_outside_2_to_128_naming_c10(
        mapped, tmp_path, monkeypatch, w):  # noqa: F811
    """Every path once refused 129 and 160 on the card (the name keeps
    the case).  Every entry point still refuses 1 naming C10 before any
    work; every entry point takes 129 and 160 past the guard (the MEA
    path's since ROADMAP C11's first step, the Viterbi path's since its
    second: their W = 256 kernels), to the device check (``meta``:
    ``unsupported device``; ``None`` without a card: no CUDA device) or
    to the stand-in chain, pack or index build."""
    monkeypatch.setattr(port_realign_stage, "chain_sam_file",
                        _past_the_guard)
    monkeypatch.setattr(dispatch, "pack_stream_pairs", _past_the_guard)
    monkeypatch.setattr("nanopore_tpu_torch.mapping.engine.KmerIndex.build",
                        _past_the_guard)
    calls = dict(_mea_entry_points(mapped, tmp_path, w),
                 **_viterbi_entry_points(w))
    for name, call in calls.items():
        with pytest.raises((ValueError, RuntimeError, _PastTheGuard)) as err:
            call()
        if w == 1:
            assert err.type is ValueError, name
            assert "C10" in str(err.value) and "C11" in str(err.value), name
            continue
        assert "C1" not in str(err.value), name
        if err.type is ValueError:
            assert "unsupported device" in str(err.value), name
        elif err.type is RuntimeError:
            assert "no CUDA device" in str(err.value), name
    assert not (tmp_path / "out.sam").exists()
    assert not (tmp_path / "r").exists()


def test_the_cpu_serves_160(pairs):
    """Above 128 the CPU runs the plain versions, the band laid into
    the card's W = 256 layout since ROADMAP C11's first step (the Viterbi
    too, which the card serves there since its second): the MEA decode and
    the Viterbi against the JAX package's XLA scans at the same width."""
    w = 160
    pairs = pairs[:2]
    assert padded_width(w) == 256
    rea = _prepared(pairs, w, {})
    assert rea.xyc.shape[2] == 256
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


@pytest.mark.parametrize("w", [65, 80, 96, 127, 128])
def test_padded_width_lays_65_to_128_into_128(w):
    assert padded_width(w) == 128
