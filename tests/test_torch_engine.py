"""The mapping slice as a whole: the port's MappingEngine on the CPU vs
the JAX package's MappingEngine, on seeded 30 kb references with noisy
1-2 kb reads on both strands and one unmappable read.  The SAM records
must agree field by field, the port's CLI must write the same file, and
without a card the port's entry points must refuse to run.

On the CPU the JAX engine decodes with the XLA scan, which rescales
every diagonal; the port rescales every 2nd one, as the Pallas kernel
does.  The two round differently, so an MEA move that is tied in exact
arithmetic can go either way: seed 2's reads hold no such tie, while
seeds 1 and 2024 each hold reads whose cigars differ from the XLA
scan's.  There every other field must still agree, and each differing
cigar must be the one the Pallas kernel (in interpret mode, on the JAX
engine's own candidate windows) decodes.
"""

import numpy as np
import pytest
import torch

import nanopore_tpu.ops.pairhmm_pallas_realign as ppr
from nanopore_tpu.io.sam import SamReader as JaxSamReader
from nanopore_tpu.mapping.engine import MappingEngine as JaxEngine
from nanopore_tpu.mapping.presets import MAPPER_REGISTRY as JAX_PRESETS
from nanopore_tpu.ops.mea import mea_traceback_fwd
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu_torch import cli
from nanopore_tpu_torch.io.encoding import decode, revcomp_codes
from nanopore_tpu_torch.mapping.engine import MapperConfig, MappingEngine
from nanopore_tpu_torch.mapping.presets import MAPPER_REGISTRY
from nanopore_tpu_torch.ops.realign import untile

# the CLI's default mapper
PRESET = "LastParams"

FIELDS = ("qname", "flag", "rname", "pos", "mapq", "cigar", "seq", "qual")


def _write_inputs(dirpath, seed):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 30_000).astype(np.int8)
    fa = dirpath / "ref.fa"
    seq = decode(ref)
    fa.write_text(">chrT\n" + "\n".join(
        seq[i:i + 70] for i in range(0, len(seq), 70)) + "\n")
    lines = []
    for r in range(8):
        L = int(rng.integers(1000, 2000))
        start = int(rng.integers(0, len(ref) - L))
        x = ref[start:start + L]
        y = x[rng.random(L) > 0.05]
        sub = rng.random(len(y)) < 0.08
        y = np.where(sub, rng.integers(0, 4, len(y)), y).astype(np.int8)
        ins = rng.random(len(y)) < 0.03
        y = np.insert(y, np.nonzero(ins)[0],
                      rng.integers(0, 4, int(ins.sum())).astype(np.int8))
        if r % 2:
            y = revcomp_codes(y)
        q = "".join(chr(33 + int(v)) for v in rng.integers(5, 40, len(y)))
        lines.append("@read_%d_%d_%d\n%s\n+\n%s\n" % (r, start, r % 2,
                                                       decode(y), q))
    junk = rng.integers(0, 4, 1200).astype(np.int8)
    lines.append("@unmappable\n%s\n+\n%s\n" % (decode(junk), "I" * 1200))
    fq = dirpath / "reads.fq"
    fq.write_text("".join(lines))
    return str(fa), str(fq)


def _records(path):
    return [
        tuple(getattr(r, f) for f in FIELDS)
        + (dict((t[0], t[2]) for t in r.tags).get("AS"),)
        for r in JaxSamReader(path)
    ]


def _map_both(d, seed):
    fa, fq = _write_inputs(d, seed)
    from nanopore_tpu.io.seqio import read_fasta_dict

    ref = read_fasta_dict(fa)
    jax_sam = str(d / "jax.sam")
    jax_engine = JaxEngine(ref, JAX_PRESETS[PRESET].config)
    jax_engine.map_fastq(fq, jax_sam)
    port_sam = str(d / "port.sam")
    engine = MappingEngine(ref, MAPPER_REGISTRY[PRESET].config, device="cpu")
    engine.map_fastq(fq, port_sam)
    return {"fa": fa, "fq": fq, "jax": jax_sam, "port": port_sam,
            "engine": engine, "jax_engine": jax_engine, "dir": d}


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    return _map_both(tmp_path_factory.mktemp("torch_engine"), 2)


@pytest.fixture
def small_kernel_geometry():
    """Pallas interpret mode at the CHUNK/SEG of
    tests/test_pallas_realign.py: same numerics, a fraction of the time."""
    old_chunk, old_seg = ppr.CHUNK, ppr.SEG
    ppr.CHUNK, ppr.SEG = 8, 4
    yield
    ppr.CHUNK, ppr.SEG = old_chunk, old_seg
    ppr._pallas_realign_call.clear_cache()


def _pallas_records(jax_engine, fq, names):
    """{(qname, flag, pos): cigar} for every candidate of the named reads,
    decoded by the Pallas kernel in interpret mode in one batch."""
    from nanopore_tpu.io.seqio import fastq_read_raw

    cfg = jax_engine.config
    cands = []
    for name, seq, _ in fastq_read_raw(fq):
        if name in names:
            cands.extend(jax_engine._candidates_for_read(name, seq))
    pairs = [
        (jax_engine.index.contig_codes(c.contig)[c.window_start:c.window_end],
         c.read_codes, c.guide)
        for c in cands
    ]
    batch = prepare_banded_batch(pairs, band_width=cfg.band_width)
    out = ppr.PallasRealignPlan(
        batch, jax_engine.params, cfg.gap_gamma, cfg.match_gamma,
        emit_em=False,
    ).run(interpret=True)
    bands = untile(out["dirs_raw"], len(pairs))
    offsets = np.asarray(batch.offsets)
    recs = {}
    for b, (c, (x, y, _)) in enumerate(zip(cands, pairs)):
        cigar = mea_traceback_fwd(bands[b], offsets[b], len(y), len(x))
        rec = jax_engine._record_from_window_cigar(c, list(cigar), {})
        if rec is not None:
            recs[(rec.qname, rec.flag, rec.pos)] = rec.cigar
    return recs


def test_sam_records_equal_field_by_field(mapped):
    want = _records(mapped["jax"])
    got = _records(mapped["port"])
    names = {r[0] for r in got}
    assert len(names) == 8 and "unmappable" not in names
    assert got == want


@pytest.mark.parametrize("seed", [1, 2024])
def test_sam_records_agree_up_to_pallas_ties(seed, tmp_path,
                                             small_kernel_geometry):
    run = _map_both(tmp_path, seed)
    want = _records(run["jax"])
    got = _records(run["port"])
    names = {r[0] for r in got}
    assert len(names) == 8 and "unmappable" not in names
    assert len(got) == len(want)
    cigar = FIELDS.index("cigar")
    differ = [(w, g) for w, g in zip(want, got) if w != g]
    assert differ, "these seeds are kept for their MEA ties"
    for w, g in differ:
        assert w[:cigar] + w[cigar + 1:] == g[:cigar] + g[cigar + 1:]
    pallas = _pallas_records(run["jax_engine"], run["fq"],
                             {g[0] for _, g in differ})
    for _, g in differ:
        assert g[cigar] == pallas[(g[0], g[1], g[3])]


def test_primaries_land_at_their_origin(mapped):
    for rec in _records(mapped["port"]):
        qname, flag, _, pos = rec[:4]
        if flag & 0x900:
            continue
        _, _, start, strand = qname.split("_")
        assert bool(flag & 0x10) == bool(int(strand))
        assert abs(pos - int(start)) <= 100


def test_cli_writes_the_same_file(mapped):
    out = mapped["dir"] / "cli.sam"
    rc = cli.main(["--log-level", "WARNING", "map", mapped["fq"],
                   mapped["fa"], str(out), "--mapper", PRESET,
                   "--device", "cpu"])
    assert rc == 0
    with open(mapped["port"]) as a, open(out) as b:
        assert a.read() == b.read()


def test_entry_points_raise_without_a_card(mapped, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from nanopore_tpu_torch.io.seqio import read_fasta_dict

    with pytest.raises(RuntimeError, match="CUDA"):
        MappingEngine(read_fasta_dict(mapped["fa"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["map", mapped["fq"], mapped["fa"],
                  str(tmp_path / "x.sam")])


def _pallas_viterbi_records(jax_engine, fq, names):
    """{(qname, flag, pos): cigar} for every candidate of the named reads,
    decoded by the Pallas Viterbi kernel in interpret mode in one batch."""
    import nanopore_tpu.ops.pairhmm_pallas_viterbi as ppv
    from nanopore_tpu.io.seqio import fastq_read_raw

    cands = []
    for name, seq, _ in fastq_read_raw(fq):
        if name in names:
            cands.extend(jax_engine._candidates_for_read(name, seq))
    pairs = [
        (jax_engine.index.contig_codes(c.contig)[c.window_start:c.window_end],
         c.read_codes, c.guide)
        for c in cands
    ]
    batch = prepare_banded_batch(pairs, band_width=jax_engine.config.band_width)
    old = ppv.CHUNK, ppv.SEG
    ppv.CHUNK, ppv.SEG = 8, 4
    try:
        out = ppv.pallas_viterbi(batch, jax_engine.params, interpret=True)
    finally:
        ppv.CHUNK, ppv.SEG = old
        ppv._pallas_viterbi_call.clear_cache()
    cigars = ppv.viterbi_traceback_batch(
        out["bp_raw"], np.asarray(batch.offsets), batch.m, batch.n,
        out["fstate"])
    recs = {}
    for c, cigar in zip(cands, cigars):
        rec = jax_engine._record_from_window_cigar(c, list(cigar), {})
        if rec is not None:
            recs[(rec.qname, rec.flag, rec.pos)] = rec.cigar
    return recs


def test_viterbi_decode_is_not_ported(mapped):
    """The Viterbi decode, once refused, now maps: the port's engine with
    ``MapperConfig(decode="viterbi")`` on the CPU against the JAX
    package's (its XLA scan), SAM records equal field by field but for a
    cigar that the Pallas Viterbi (interpret mode) decodes as the port
    does: the XLA scan's tables break an exact max-product tie the other
    way (tests/test_torch_viterbi.py)."""
    from nanopore_tpu.mapping.engine import MapperConfig as JaxConfig
    from nanopore_tpu.io.seqio import read_fasta_dict

    d = mapped["dir"]
    ref = read_fasta_dict(mapped["fa"])
    jax_engine = JaxEngine(ref, JaxConfig(decode="viterbi"))
    jax_engine.map_fastq(mapped["fq"], str(d / "jax_vit.sam"))
    engine = MappingEngine(ref, MapperConfig(decode="viterbi"), device="cpu")
    engine.map_fastq(mapped["fq"], str(d / "port_vit.sam"))
    want = _records(str(d / "jax_vit.sam"))
    got = _records(str(d / "port_vit.sam"))
    names = {r[0] for r in got}
    assert len(names) == 8 and "unmappable" not in names
    assert len(got) == len(want)
    cigar = FIELDS.index("cigar")
    differ = [(w, g) for w, g in zip(want, got) if w != g]
    for w, g in differ:
        assert w[:cigar] + w[cigar + 1:] == g[:cigar] + g[cigar + 1:]
    if differ:
        pallas = _pallas_viterbi_records(jax_engine, mapped["fq"],
                                         {g[0] for _, g in differ})
        for _, g in differ:
            assert g[cigar] == pallas[(g[0], g[1], g[3])]
    for qname, flag, _, pos in (r[:4] for r in got):
        if not flag & 0x900:  # every primary at its origin
            _, _, start, strand = qname.split("_")
            assert bool(flag & 0x10) == bool(int(strand))
            assert abs(pos - int(start)) <= 100


def test_unported_paths_raise(mapped):
    """A model outside the canonical fiveState structure (gap state 2
    entered from gap state 1, as in tests/test_viterbi.py) is served (the
    name is the one this test had when it checked the refusal of ROADMAP
    C7): the plain Viterbi gives it the int16 full plane, and through
    ``prepared_from_pairs`` it decodes to the JAX package's XLA route
    (scores 1e-5 relative, the same cigars).  The canonical model passes
    through the same call on the int8 byte plane."""
    from nanopore_tpu.ops import dispatch as jax_dispatch
    from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
    from nanopore_tpu.align.model import PairHmmModel as JaxModel
    from nanopore_tpu_torch.ops import dispatch
    from nanopore_tpu_torch.ops.pack import pack_stream_pairs, pack_xyc
    from nanopore_tpu_torch.ops.pairhmm import params_from_numpy
    from nanopore_tpu_torch.ops.viterbi import viterbi_forward_plain

    params = mapped["engine"].params
    t = params.t.numpy().astype(np.float64).copy()
    t[1, 2] = 0.05
    t[1] /= t[1].sum()
    bad = params_from_numpy(t, params.e_match_flat, params.e_gap_flat)
    jp = jax_params(JaxModel.default())
    jp = jp._replace(t=np.asarray(t, np.float32))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, 40).astype(np.int8)
    pairs = [(x, x[:30].copy(), [(0, 30), (2, 10)])]
    prep = pack_stream_pairs(pairs, 8, 128)
    m, n = torch.from_numpy(prep["m"]), torch.from_numpy(prep["n"])
    xyc = pack_xyc(torch.from_numpy(prep["stream"]),
                   torch.from_numpy(prep["initx"]), m, n)
    assert viterbi_forward_plain(xyc, m, n, bad)["bp"].dtype == torch.int16
    scores, cigars = dispatch.prepared_from_pairs(
        {"device": "cpu"}, pairs, bad, band_width=8,
        prepared_cls=dispatch.PreparedViterbi,
    ).decode()
    want_scores, want = jax_dispatch.prepared_from_pairs(
        {}, pairs, jp, band_width=8,
        prepared_cls=jax_dispatch.PreparedViterbi,
    ).decode()
    np.testing.assert_allclose(scores, want_scores, rtol=1e-5)
    assert [list(c) for c in cigars] == [list(c) for c in want]
    # the canonical model passes through the same call
    out = dispatch.prepared_from_pairs(
        {"device": "cpu"}, pairs, params, band_width=8,
        prepared_cls=dispatch.PreparedViterbi,
    ).run()
    assert out["bp"].dtype == torch.int8
