"""The port's chain and realign stages vs the JAX package's.

* ``chain_sam_file`` / ``combine_sam_files``: output files identical, on
  an engine-mapped SAM (primaries and secondaries on both strands) and
  on hand-split local alignments.
* ``window_global_pair``, ``split_window_pair``, ``splice_window_cigar``:
  identical on seeded guides and on a guide that ends in a read-end
  insert after the reference's remainder.
* ``realign_records`` with ``split_k=1500`` against unsplit, in the
  port: identical cigars at the low noise of
  tests/test_edge_cases.py::test_split_realign_matches_unsplit (at
  realistic noise the bar would be aligned-pair agreement).
* ``realign_sam_file`` at W = 32 against the JAX package: every field
  equal; a cigar that differs from the XLA scan's must be the one the
  Pallas kernel (interpret mode) decodes on the same window, the rule of
  tests/test_torch_engine.py for MEA moves tied in exact arithmetic.
* ``realign_records(rescore=True)`` against the JAX package's: each
  record's average posterior match probability of its new cigar within
  1e-4, cigars under the same tie rule.
"""

import numpy as np
import pytest

import nanopore_tpu.ops.pairhmm_pallas_realign as ppr
from nanopore_tpu.align import chain_sam as jax_chain
from nanopore_tpu.align import realign as jax_realign
from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.io.sam import SamReader as JaxSamReader
from nanopore_tpu.io.seqio import read_fasta_dict
from nanopore_tpu.mapping.engine import MappingEngine as JaxEngine
from nanopore_tpu.mapping.presets import MAPPER_REGISTRY as JAX_PRESETS
from nanopore_tpu.ops.mea import mea_traceback_fwd
from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu_torch.align import chain_sam, realign
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.io.encoding import decode, encode, revcomp_codes
from nanopore_tpu_torch.io.sam import (
    CIG,
    SamRecord,
    SamWriter,
    cigar_to_string,
)
from nanopore_tpu_torch.ops.realign import max_workspace_k, untile

FIELDS = ("qname", "flag", "rname", "pos", "mapq", "cigar", "seq", "qual")


def write_small_inputs(dirpath, seed, n_reads=8, ref_len=6000):
    """A seeded reference and noisy 260-400 base reads on both strands
    (names read_<i>_<start>_<strand>)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, ref_len).astype(np.int8)
    fa = dirpath / "ref.fa"
    seq = decode(ref)
    fa.write_text(">chrT\n" + "\n".join(
        seq[i:i + 70] for i in range(0, len(seq), 70)) + "\n")
    lines = []
    for r in range(n_reads):
        L = int(rng.integers(260, 400))
        start = int(rng.integers(0, len(ref) - L))
        x = ref[start:start + L]
        y = x[rng.random(L) > 0.04]
        sub = rng.random(len(y)) < 0.06
        y = np.where(sub, rng.integers(0, 4, len(y)), y).astype(np.int8)
        ins = rng.random(len(y)) < 0.02
        y = np.insert(y, np.nonzero(ins)[0],
                      rng.integers(0, 4, int(ins.sum())).astype(np.int8))
        if r % 2:
            y = revcomp_codes(y)
        lines.append("@read_%d_%d_%d\n%s\n+\n%s\n" % (
            r, start, r % 2, decode(y), "I" * len(y)))
    fq = dirpath / "reads.fq"
    fq.write_text("".join(lines))
    return str(fa), str(fq)


def sam_records(path):
    return [tuple(getattr(r, f) for f in FIELDS) for r in JaxSamReader(path)]


def pallas_window_cigar(rec, ref_codes, model, gap_gamma, match_gamma,
                        band_width):
    """The full-reference cigar the Pallas kernel (interpret mode)
    decodes for one chained record, on the window the realign stage
    takes (``rec`` holds the chained guide)."""
    old = ppr.CHUNK, ppr.SEG
    ppr.CHUNK, ppr.SEG = 8, 4
    try:
        xw, guide, j0, j1 = jax_realign.window_global_pair(
            ref_codes, rec.cigar)
        y = np.asarray(encode(rec.seq))
        batch = prepare_banded_batch([(xw, y, guide)], band_width=band_width)
        out = ppr.PallasRealignPlan(
            batch, jax_params(model), gap_gamma, match_gamma, emit_em=False,
        ).run(interpret=True)
        band = untile(out["dirs_raw"], 1)[0]
        cigar = mea_traceback_fwd(band, np.asarray(batch.offsets)[0],
                                  len(y), len(xw))
        return jax_realign.splice_window_cigar(list(cigar), j0, j1,
                                               len(ref_codes))
    finally:
        ppr.CHUNK, ppr.SEG = old
        ppr._pallas_realign_call.clear_cache()


def assert_sam_equal_up_to_pallas_ties(port_sam, jax_sam, chained_sam, fa,
                                       model, gap_gamma, match_gamma,
                                       band_width):
    """Every field equal; a differing cigar must be the Pallas decode of
    the record's chained guide (found by qname in ``chained_sam``)."""
    got, want = sam_records(port_sam), sam_records(jax_sam)
    assert len(got) == len(want) and got
    cig = FIELDS.index("cigar")
    differ = [(w, g) for w, g in zip(want, got) if w != g]
    if not differ:
        return 0
    ref = {k: np.asarray(encode(v)) for k, v in read_fasta_dict(fa).items()}
    guides = {r.qname: r for r in JaxSamReader(chained_sam)}
    for w, g in differ:
        assert w[:cig] + w[cig + 1:] == g[:cig] + g[cig + 1:]
        rec = guides[g[0]]
        assert g[cig] == pallas_window_cigar(
            rec, ref[rec.rname], model, gap_gamma, match_gamma, band_width)
    return len(differ)


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_chain_realign")
    fa, fq = write_small_inputs(d, 1)
    sam = str(d / "mapping.sam")
    JaxEngine(read_fasta_dict(fa), JAX_PRESETS["LastParams"].config
              ).map_fastq(fq, sam)
    return {"dir": d, "fa": fa, "fq": fq, "sam": sam}


def test_chain_sam_file_identical_on_a_mapped_sam(mapped):
    d = mapped["dir"]
    jax_chain.chain_sam_file(mapped["sam"], str(d / "j_chain.sam"),
                             mapped["fq"], mapped["fa"])
    chain_sam.chain_sam_file(mapped["sam"], str(d / "p_chain.sam"),
                             mapped["fq"], mapped["fa"])
    a = (d / "p_chain.sam").read_text()
    assert a == (d / "j_chain.sam").read_text()
    recs = list(JaxSamReader(str(d / "p_chain.sam")))
    assert len(recs) == 8 and all(r.pos == 0 for r in recs)


def test_chain_merges_split_local_alignments(tmp_path):
    """Two local pieces of each read (soft-clipped, 5 bases apart on
    both sequences) chain into one global record, on both strands."""
    rng = np.random.default_rng(4)
    ref = rng.integers(0, 4, 400).astype(np.int8)
    fa = tmp_path / "ref.fa"
    fa.write_text(">r\n%s\n" % decode(ref))
    fq_lines, recs = [], []
    for i, (start, rev) in enumerate([(30, False), (150, True)]):
        y = ref[start:start + 100]
        read = revcomp_codes(y) if rev else y
        fq_lines.append("@q%d\n%s\n+\n%s\n" % (i, decode(read), "I" * 100))
        flag = 0x10 if rev else 0
        recs.append(SamRecord(qname="q%d" % i, flag=flag, rname="r",
                              pos=start, mapq=60,
                              cigar=[(CIG.M, 45), (CIG.S, 55)],
                              seq=decode(y)))
        recs.append(SamRecord(qname="q%d" % i, flag=flag | 0x800, rname="r",
                              pos=start + 50, mapq=60,
                              cigar=[(CIG.S, 50), (CIG.M, 50)],
                              seq=decode(y)))
    fq = tmp_path / "reads.fq"
    fq.write_text("".join(fq_lines))
    sam = tmp_path / "local.sam"
    with SamWriter(str(sam), {"r": 400}) as w:
        for rec in recs:
            w.write(rec)
    jax_chain.chain_sam_file(str(sam), str(tmp_path / "j.sam"), str(fq),
                             str(fa))
    chain_sam.chain_sam_file(str(sam), str(tmp_path / "p.sam"), str(fq),
                             str(fa))
    assert (tmp_path / "p.sam").read_text() == (tmp_path / "j.sam").read_text()
    out = list(JaxSamReader(str(tmp_path / "p.sam")))
    assert len(out) == 2
    for rec in out:
        ops = dict.fromkeys("MID", 0)
        for op, ln in rec.cigar:
            ops["MIDNSHP=X"[op]] += ln
        assert ops["M"] == 95 and ops["M"] + ops["D"] == 400
        assert ops["M"] + ops["I"] == 100
    jax_chain.combine_sam_files(str(sam), [str(tmp_path / "j.sam")],
                                str(tmp_path / "jc.sam"))
    chain_sam.combine_sam_files(str(sam), [str(tmp_path / "p.sam")],
                                str(tmp_path / "pc.sam"))
    assert (tmp_path / "pc.sam").read_text() == \
        (tmp_path / "jc.sam").read_text()


def _seeded_global_guide(seed):
    """(ref codes, read codes, global guide) with lead/tail deletions
    and indels inside."""
    rng = np.random.default_rng(seed)
    lead, tail = int(rng.integers(0, 700)), int(rng.integers(0, 700))
    guide, n, m = [], lead, 0
    if lead:
        guide.append((CIG.D, lead))
    for _ in range(int(rng.integers(3, 9))):
        run = int(rng.integers(40, 900))
        guide.append((CIG.M, run))
        n += run
        m += run
        op = (CIG.D, CIG.I)[int(rng.integers(0, 2))]
        gap = int(rng.integers(1, 12))
        guide.append((op, gap))
        n += gap if op == CIG.D else 0
        m += gap if op == CIG.I else 0
    guide.append((CIG.M, 30))
    n += 30 + tail
    m += 30
    if tail:
        guide.append((CIG.D, tail))
    x = rng.integers(0, 4, n).astype(np.int8)
    y = rng.integers(0, 4, m).astype(np.int8)
    return x, y, guide


@pytest.mark.parametrize("seed", range(6))
def test_window_split_splice_identical(seed):
    x, y, guide = _seeded_global_guide(seed)
    for pad in (0, 128, 256):
        want = jax_realign.window_global_pair(x, guide, pad=pad)
        got = realign.window_global_pair(x, guide, pad=pad)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    xw, gw, j0, j1 = realign.window_global_pair(x, guide)
    assert realign.splice_window_cigar(gw, j0, j1, len(x)) == \
        jax_realign.splice_window_cigar(gw, j0, j1, len(x))
    merged = realign.splice_window_cigar(gw, j0, j1, len(x))
    assert sum(ln for op, ln in merged if op in (CIG.M, CIG.D)) == len(x)
    # at and above 4096 both packages clamp the budget to a 2048 multiple
    for max_k in (600, 1500, 2048, 4096, 10000):
        want = jax_realign.split_window_pair(xw, y, gw, max_k)
        got = realign.split_window_pair(xw, y, gw, max_k)
        assert got == want
        assert got[0][0] == 0 and got[0][2] == 0
        assert got[-1][1] == len(xw) and got[-1][3] == len(y)


def test_window_of_a_read_end_insert_reaches_the_reference_end_as_in_jax():
    """The chainer writes a read's unaligned last bases after the
    reference's remainder ("... 900D 2I").  That cigar has no trailing
    deletion run, so in both packages the window runs to the end of the
    reference, and the realigned record is global again."""
    x = np.random.default_rng(0).integers(0, 4, 1500).astype(np.int8)
    guide = [(CIG.D, 400), (CIG.M, 150), (CIG.I, 3), (CIG.M, 50),
             (CIG.D, 900), (CIG.I, 2)]
    for pad in (0, 64, 128):
        want = jax_realign.window_global_pair(x, guide, pad=pad)
        got = realign.window_global_pair(x, guide, pad=pad)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    xw, gw, j0, j1 = realign.window_global_pair(x, guide, pad=64)
    assert (j0, j1) == (336, 1500)
    assert gw == [(CIG.D, 64)] + guide[1:]
    full = realign.splice_window_cigar(gw, j0, j1, len(x))
    assert full == jax_realign.splice_window_cigar(gw, j0, j1, len(x))
    assert sum(ln for op, ln in full if op in (CIG.M, CIG.D)) == 1500
    assert sum(ln for op, ln in full if op in (CIG.M, CIG.I)) == 205
    rec = SamRecord(qname="q", flag=0, rname="r", pos=0, mapq=60,
                    cigar=list(guide),
                    seq=decode(np.concatenate([x[400:550], x[:3],
                                               x[550:600], x[:2]])))
    realign.realign_records([rec], {"r": decode(x)}, band_width=16,
                            device="cpu")
    assert sum(ln for op, ln in rec.cigar if op in (CIG.M, CIG.D)) == 1500
    assert sum(ln for op, ln in rec.cigar if op in (CIG.M, CIG.I)) == 205
    assert rec.cigar[0] == (CIG.D, 400)


def test_split_budget_is_clamped_between_2049_and_4095():
    """A budget in 2049-4095 is clamped to a 2048 multiple too (the JAX
    package clamps only from 4096 on), so a segment's diagonal count,
    rounded up in 2048 steps by the pack, never exceeds ``max_k``."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 4, 9000).astype(np.int8)
    y = x[50:8950].copy()
    guide = [(CIG.D, 50), (CIG.M, 8900), (CIG.D, 50)]
    for max_k in (2500, 3000, 4000, 4096, 10000):
        segs = realign.split_window_pair(x, y, guide, max_k=max_k)
        assert len(segs) > 1
        for sj0, sj1, si0, si1, _ in segs:
            need = (sj1 - sj0) + (si1 - si0)
            assert -(-need // 2048) * 2048 <= max_k, (max_k, need)
    with pytest.raises(ValueError):
        realign.split_window_pair(x, y[:-1], guide, max_k=3000)
    assert max_workspace_k(64) > 1 << 22 and \
        max_workspace_k(32) > max_workspace_k(64)


def test_split_realign_matches_unsplit():
    rng = np.random.default_rng(3)
    n = 2400
    x = rng.integers(0, 4, n).astype(np.int8)
    ref = {"r": decode(x)}

    def make_records():
        r = np.random.default_rng(8)
        recs = []
        for s, lead in enumerate((200, 900)):
            mlen = 1000
            y = x[lead:lead + mlen].copy()
            idx = r.integers(0, mlen, 40)
            y[idx] = (y[idx] + 1) % 4
            recs.append(SamRecord(
                qname="q%d" % s, flag=0, rname="r", pos=0, mapq=60,
                cigar=[(CIG.D, lead), (CIG.M, mlen),
                       (CIG.D, n - lead - mlen)],
                seq=decode(y)))
        return recs

    model = PairHmmModel.default()
    plain = make_records()
    assert realign.realign_records(plain, ref, model, band_width=16,
                                   device="cpu") == []
    split = make_records()
    realign.realign_records(split, ref, model, band_width=16, split_k=1500,
                            device="cpu")
    for a, b in zip(plain, split):
        assert cigar_to_string(a.cigar) == cigar_to_string(b.cigar)
        assert sum(ln for op, ln in a.cigar if op in (CIG.M, CIG.D)) == n
    # the window of each read (1000 + 256 + 1000 diagonals) was over budget
    xw, gw, _, _ = realign.window_global_pair(x, make_records()[0].cigar)
    assert len(realign.split_window_pair(
        xw, encode(make_records()[0].seq), gw, 1500)) == 2


def test_realign_sam_file_matches_jax_at_w32(mapped):
    d = mapped["dir"]
    jax_realign.realign_sam_file(
        mapped["sam"], str(d / "j_realign.sam"), mapped["fq"], mapped["fa"],
        band_width=32)
    realign.realign_sam_file(
        mapped["sam"], str(d / "p_realign.sam"), mapped["fq"], mapped["fa"],
        band_width=32, device="cpu")
    jax_chain.chain_sam_file(mapped["sam"], str(d / "guides.sam"),
                             mapped["fq"], mapped["fa"])
    assert_sam_equal_up_to_pallas_ties(
        str(d / "p_realign.sam"), str(d / "j_realign.sam"),
        str(d / "guides.sam"), mapped["fa"], JaxModel.default(), 0.5, 0.0, 32)
    recs = list(JaxSamReader(str(d / "p_realign.sam")))
    assert len(recs) == 8
    # the realign moved at least one cigar off its chained guide
    guides = {r.qname: r.cigar for r in JaxSamReader(str(d / "guides.sam"))}
    assert any(r.cigar != guides[r.qname] for r in recs)
    # sharded: every 2nd chained record, in chained order
    realign.realign_sam_file(
        mapped["sam"], str(d / "p_shard.sam"), mapped["fq"], mapped["fa"],
        band_width=32, shard=(1, 2), device="cpu")
    assert sam_records(str(d / "p_shard.sam")) == \
        sam_records(str(d / "p_realign.sam"))[1::2]


def test_pallas_tie_helper_decodes_the_port_cigar(mapped):
    """The helper the tie rule relies on: for a record without a tie it
    returns the cigar both packages wrote."""
    d = mapped["dir"]
    jax_chain.chain_sam_file(mapped["sam"], str(d / "guides2.sam"),
                             mapped["fq"], mapped["fa"])
    guide = next(iter(JaxSamReader(str(d / "guides2.sam"))))
    ref = read_fasta_dict(mapped["fa"])
    recs = [SamRecord(qname=guide.qname, flag=guide.flag, rname=guide.rname,
                      pos=0, mapq=guide.mapq, cigar=list(guide.cigar),
                      seq=guide.seq)]
    realign.realign_records(recs, ref, PairHmmModel.default(), band_width=32,
                            device="cpu")
    want = pallas_window_cigar(guide, np.asarray(encode(ref[guide.rname])),
                               JaxModel.default(), 0.5, 0.0, 32)
    assert recs[0].cigar == want


def test_rescore_matches_jax(mapped):
    """``rescore=True``: the decode + gamma launch, the walker and the
    rescore of the new cigars.  Scores within 1e-4 of the JAX package's
    (its two-pass forward_backward route on the CPU); a cigar may differ
    only under the tie rule above, and its score then is the JAX
    package's rescore of the port's cigar on the JAX band."""
    d = mapped["dir"]
    jax_chain.chain_sam_file(mapped["sam"], str(d / "guides3.sam"),
                             mapped["fq"], mapped["fa"])
    ref = read_fasta_dict(mapped["fa"])
    guides = list(JaxSamReader(str(d / "guides3.sam")))
    want = [SamRecord(qname=g.qname, flag=g.flag, rname=g.rname, pos=0,
                      mapq=g.mapq, cigar=list(g.cigar), seq=g.seq)
            for g in guides]
    got = [SamRecord(qname=g.qname, flag=g.flag, rname=g.rname, pos=0,
                     mapq=g.mapq, cigar=list(g.cigar), seq=g.seq)
           for g in guides]
    want_scores = jax_realign.realign_records(
        want, ref, JaxModel.default(), band_width=32, rescore=True)
    got_scores = realign.realign_records(
        got, ref, PairHmmModel.default(), band_width=32, rescore=True,
        device="cpu")
    assert len(got_scores) == len(want_scores) == len(guides) == 8
    ref_codes = {k: np.asarray(encode(v)) for k, v in ref.items()}
    for g, w, gs, ws, guide in zip(got, want, got_scores, want_scores,
                                   guides):
        assert 0.0 < gs <= 1.0
        if g.cigar == w.cigar:
            assert gs == pytest.approx(ws, abs=1e-4)
            continue
        assert g.cigar == pallas_window_cigar(
            guide, ref_codes[guide.rname], JaxModel.default(), 0.5, 0.0, 32)
        assert gs == pytest.approx(
            jax_rescore_window(guide, g.cigar, ref_codes[guide.rname]),
            abs=1e-4)


def jax_rescore_window(guide, cigar, ref_codes):
    """The JAX package's rescore of a full-reference ``cigar`` over the
    forward_backward band of ``guide``'s realign window at W = 32."""
    from nanopore_tpu.ops.mea import rescore_by_posterior
    from nanopore_tpu.ops.pairhmm import forward_backward

    xw, gw, j0, j1 = jax_realign.window_global_pair(ref_codes, guide.cigar)
    batch = prepare_banded_batch([(xw, np.asarray(encode(guide.seq)), gw)],
                                 band_width=32)
    fb = forward_backward(batch, jax_params(JaxModel.default()))
    window = list(cigar)
    if j0:
        window[0] = (window[0][0], window[0][1] - j0)
    if len(ref_codes) - j1:
        window[-1] = (window[-1][0], window[-1][1] - (len(ref_codes) - j1))
    window = [(op, ln) for op, ln in window if ln]
    return rescore_by_posterior(np.asarray(fb["gamma_match"])[0],
                                np.asarray(batch.offsets)[0], window)


def test_realign_requires_global_records():
    with pytest.raises(ValueError):
        realign.realign_records(
            [SamRecord(qname="q", flag=0, rname="r", pos=3, mapq=0,
                       cigar=[(CIG.M, 4)], seq="ACGT")],
            {"r": "ACGTACGT"}, device="cpu")
    assert realign.realign_records([], {}, rescore=True, device="cpu") == []


# ---- ROADMAP C10, C11: widths the card's kernels do not serve (above 512) - #

@pytest.mark.parametrize("device", [None, "cuda", "meta"])
def test_c10_realign_refuses_an_unserved_width_off_the_cpu(
        mapped, tmp_path, monkeypatch, device):
    """At W = 2049 off the CPU (the card serves 2 to 2048 on the MEA path
    since ROADMAP C11's seventh step; the case once used 160, 300, 513,
    then 1025),
    ``realign_records`` and ``realign_sam_file`` raise a ``ValueError``
    naming C10 before any work: before
    ``resolve_device`` (which would raise ``RuntimeError`` here, without
    a card, and another ``ValueError`` on ``meta``) and before the SAM
    is chained."""
    def no_chain(*args, **kwargs):
        raise AssertionError("chained before the width check")

    monkeypatch.setattr(realign, "chain_sam_file", no_chain)
    recs = [SamRecord(qname="q", flag=0, rname="chrT", pos=0, mapq=0,
                      cigar=[(CIG.M, 8)], seq="ACGTACGT")]
    with pytest.raises(ValueError, match="C10"):
        realign.realign_records(recs, {"chrT": "ACGTACGT"}, band_width=2049,
                                device=device)
    out = tmp_path / "out.sam"
    with pytest.raises(ValueError, match="C10"):
        realign.realign_sam_file(mapped["sam"], str(out), mapped["fq"],
                                 mapped["fa"], band_width=2049, device=device)
    assert not out.exists()


def test_c10_realign_subcommand_refuses_an_unserved_width(mapped, tmp_path):
    from nanopore_tpu_torch import cli

    out = tmp_path / "out.sam"
    with pytest.raises(ValueError, match="C10"):
        cli.main(["realign", mapped["sam"], mapped["fq"], mapped["fa"],
                  str(out), "--band-width", "2049"])
    assert not out.exists()


def test_c10_realign_on_the_cpu_serves_w48_as_jax_does(mapped):
    """The CPU path keeps serving any width: at W = 48 the cigars equal
    the JAX package's (its XLA scan, which it takes for a width outside
    its Pallas set)."""
    d = mapped["dir"]
    jax_realign.realign_sam_file(
        mapped["sam"], str(d / "j_w48.sam"), mapped["fq"], mapped["fa"],
        band_width=48)
    realign.realign_sam_file(
        mapped["sam"], str(d / "p_w48.sam"), mapped["fq"], mapped["fa"],
        band_width=48, device="cpu")
    got = sam_records(str(d / "p_w48.sam"))
    assert len(got) == 8
    assert got == sam_records(str(d / "j_w48.sam"))
