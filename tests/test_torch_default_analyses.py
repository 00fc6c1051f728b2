"""The port's analyses against the JAX package's, on the CPU.

Each analysis the pipeline ports (Substitutions, Local/GlobalCoverage,
Indels, Kmer, IndelKmer, ChannelMappability, Hmm, Consensus, FastQC,
QualiMap) runs in both packages on the JAX engine's SAM of
tests/test_analyses.py's experiment (``device="cpu"`` in the port);
every data file must be byte-identical, PDFs and PNGs excluded.  ``Hmm``
reads a model of ``models/`` written as the EM's ``hmm.txt.xml``.
Also the plotting layer's statistics: ``resampled_ks_pvalues``,
``kmer_significance`` above the reference's data-size gate, and
``venn_counts``; the read sampler; and the registries.
"""

import os
import shutil

import numpy as np
import pytest

import nanopore_tpu.analyses as jax_analyses
from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.analyses import plots as jax_plots
from nanopore_tpu.analyses.read_sampler import (
    sample_reads_file as jax_sample_reads_file,
)
import nanopore_tpu_torch.analyses as analyses
from nanopore_tpu_torch.analyses import plots
from nanopore_tpu_torch.analyses.kmer import count_kmers_both_strands
from nanopore_tpu_torch.analyses.read_sampler import sample_reads_file
from nanopore_tpu_torch.analyses.alignment_uncertainty import trained_hmm_path
from test_torch_analyses import experiment  # noqa: F401  (a fixture)

PORTED = ["Substitutions", "LocalCoverage", "GlobalCoverage", "Indels",
          "KmerAnalysis", "IndelKmerAnalysis", "ChannelMappability", "Hmm",
          "Consensus", "FastQC", "QualiMap"]
PLOTS = (".pdf", ".png")


def data_files(d) -> dict:
    """{name: bytes} of an output directory's data files."""
    return {
        f: open(os.path.join(d, f), "rb").read()
        for f in sorted(os.listdir(d)) if not f.endswith(PLOTS)
    }


@pytest.fixture(scope="module")
def hmm_experiment(experiment, tmp_path_factory):  # noqa: F811
    """The experiment's SAM beside an ``hmm.txt.xml``: blasr_hmm_0 with
    seeded standard deviations and two running-likelihood traces."""
    d = tmp_path_factory.mktemp("torch_hmm_exp")
    sam = str(d / "mapping.sam")
    shutil.copy(experiment["sam"], sam)
    rng = np.random.default_rng(5)
    model = JaxModel.load(trained_hmm_path("blasr_hmm_0.txt"))
    model.running_likelihoods = [
        list(np.cumsum(rng.random(4)) - 100.0) for _ in range(2)]
    model.write_xml(str(d / "hmm.txt.xml"),
                    transitions_std=rng.random(model.transitions.shape),
                    emissions_std=rng.random(model.emissions.shape) * 1e-3)
    return dict(experiment, sam=sam)


@pytest.mark.parametrize("name", PORTED)
def test_analysis_writes_the_jax_packages_data_files(
        name, experiment, hmm_experiment, tmp_path):  # noqa: F811
    exp = hmm_experiment if name == "Hmm" else experiment
    outs = []
    for tag, cls, kw in (
        ("jax", jax_analyses.ALL_ANALYSES[name], {}),
        ("port", analyses.ALL_ANALYSES[name], {"device": "cpu"}),
    ):
        out = str(tmp_path / tag)
        os.makedirs(out)
        a = cls(exp["fq"], "2d", exp["fa"], exp["sam"], out, **kw)
        a.execute()
        assert cls.is_finished(out)
        outs.append(data_files(out))
    jax_files, port_files = outs
    assert len(jax_files) > 1, "the analysis wrote no data file"
    assert list(port_files) == list(jax_files)
    for f in jax_files:
        assert port_files[f] == jax_files[f], f


def test_registries_match_the_jax_package():
    assert list(analyses.ALL_ANALYSES) == list(jax_analyses.ALL_ANALYSES)
    assert [c.__name__ for c in analyses.DEFAULT_ANALYSES] == \
        [c.__name__ for c in jax_analyses.DEFAULT_ANALYSES]
    assert set(PORTED) | {"AlignmentUncertainty", "MarginAlignSnpCaller"} \
        == set(analyses.ALL_ANALYSES)


@pytest.mark.parametrize("batch_codes", [1, 50, 1 << 24])
def test_count_kmers_both_strands_matches_per_read_counts(batch_codes,
                                                          monkeypatch):
    """The port counts a batch of sequences, joined, in one call (a
    batch of one sequence, of a few, of all); the JAX package counts each
    sequence and sums on the host.  Equal counts."""
    from nanopore_tpu.analyses.kmer import (
        count_kmers_both_strands as jax_count,
    )
    from nanopore_tpu_torch.analyses import kmer

    monkeypatch.setattr(kmer, "KMER_BATCH_CODES", batch_codes)
    rng = np.random.default_rng(3)
    for k in (1, 3, 5):
        seqs = ["".join("ACGTN"[c] for c in rng.integers(0, 5, n))
                for n in (0, 3, 5, 6, 1, 40, 700, 2, 6, 31)]
        seqs += ["ACGT" * 30, "A" * (k + 1), "C" * k]
        port = count_kmers_both_strands(iter(seqs), k, device="cpu")
        assert port.dtype == np.int64
        np.testing.assert_array_equal(port, jax_count(seqs, k))


@pytest.mark.parametrize("n,shift", [(64, 1.0), (256, 8.0)])
def test_resampled_ks_pvalues_equal(n, shift):
    rng = np.random.default_rng(n)
    ref = rng.random(n)
    read = ref.copy()
    read[: n // 8] *= shift
    kw = dict(num_trials=200, trial_size=2000, seed=4)
    np.testing.assert_array_equal(
        plots.resampled_ks_pvalues(ref, read, **kw),
        jax_plots.resampled_ks_pvalues(ref, read, **kw))


def test_kmer_significance_above_the_gate_equal(tmp_path):
    """The KS branch (refCount > 1000, readCount > 10000): both p-value
    tables byte-identical."""
    rng = np.random.default_rng(9)
    counts = str(tmp_path / "counts.txt")
    ref = rng.integers(1, 40, 1024)
    read = rng.integers(0, 400, 1024)
    read[:5] = 0
    with open(counts, "w") as fh:
        fh.write("kmer\trefCount\trefFraction\treadCount\treadFraction\t"
                 "logFoldChange\n")
        for i in range(1024):
            rf, qf = ref[i] / ref.sum(), read[i] / read.sum()
            fold = "Inf" if qf == 0 else str(-np.log(qf / rf))
            fh.write("k%d\t%d\t%s\t%d\t%s\t%s\n"
                     % (i, ref[i], rf, read[i], qf, fold))
    for mod, tag in ((jax_plots, "j"), (plots, "p")):
        mod.kmer_significance(counts, str(tmp_path / (tag + "_pval.txt")),
                              str(tmp_path / (tag + "_top.txt")),
                              str(tmp_path / (tag + ".pdf")), "Kmer")
    for f in ("_pval.txt", "_top.txt"):
        assert (tmp_path / ("p" + f)).read_bytes() == \
            (tmp_path / ("j" + f)).read_bytes()


@pytest.mark.parametrize("n_sets", [1, 2, 3, 4, 5])
def test_venn_counts_equal(n_sets):
    rng = np.random.default_rng(n_sets)
    reads = ["read%d" % i for i in range(60)]
    sets = {"M%d" % j: {r for r in reads if rng.random() < 0.4}
            for j in range(n_sets)}
    universe = set(reads)
    assert plots.venn_counts(sets, universe) == \
        jax_plots.venn_counts(sets, universe)
    assert plots.venn_counts(sets) == jax_plots.venn_counts(sets)


def test_sample_reads_file_equal(experiment, tmp_path):  # noqa: F811
    for frac in (0.25, 0.75):
        p = sample_reads_file(experiment["fq"], frac,
                              str(tmp_path / "p.fq"), seed=2)
        j = jax_sample_reads_file(experiment["fq"], frac,
                                  str(tmp_path / "j.fq"), seed=2)
        assert open(p, "rb").read() == open(j, "rb").read()


def test_alignment_uncertainty_band_cap_splits_without_changing_a_read(
        experiment, tmp_path, monkeypatch):  # noqa: F811
    """A bucket whose gamma band would pass ``GAMMA_BAND_BYTES`` runs in
    smaller batches (here one read each): the XML stays byte-identical."""
    from nanopore_tpu_torch.analyses import alignment_uncertainty as au

    outs = []
    for tag, cap in (("whole", au.GAMMA_BAND_BYTES), ("split", 600_000)):
        monkeypatch.setattr(au, "GAMMA_BAND_BYTES", cap)
        out = tmp_path / tag
        out.mkdir()
        au.AlignmentUncertainty(experiment["fq"], "2d", experiment["fa"],
                                experiment["sam"], str(out),
                                device="cpu").execute()
        outs.append((out / "alignmentUncertainty.xml").read_bytes())
    assert outs[0] == outs[1]
    assert len(au.ExperimentData(experiment["fq"], experiment["fa"],
                                 experiment["sam"]).records) > 1


def _random_cigars(seed, count):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        ops = rng.choice(list("MMMIDDNSHP=X"), rng.integers(0, 40))
        lens = rng.choice([1, 1, 2, 3, 5, 6, 7, 12, 30, 200], len(ops))
        yield "".join("%d%s" % (l, op) for op, l in zip(ops, lens)), int(
            rng.integers(0, 50))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_record_columns_match_the_jax_records(seed):
    """``parse_cigar``, ``aligned_pair_arrays`` (vectorised in the port)
    and ``aligned_columns`` against the JAX package's record."""
    from nanopore_tpu.io.sam import SamRecord as JaxRecord
    from nanopore_tpu.io.sam import parse_cigar as jax_parse
    from nanopore_tpu_torch.io.sam import SamRecord, parse_cigar

    for text in ("", "*", "10M5", "M", "3M2I"):
        assert parse_cigar(text) == jax_parse(text)
    for text, pos in _random_cigars(seed, 300):
        cigar = parse_cigar(text)
        assert cigar == jax_parse(text)
        want = JaxRecord(qname="r", flag=0, rname="x", pos=pos, cigar=cigar,
                         seq="A")
        got = SamRecord(qname="r", flag=0, rname="x", pos=pos, cigar=cigar,
                        seq="A")
        for a, b in zip(got.aligned_pair_arrays(), want.aligned_pair_arrays()):
            assert a.dtype == b.dtype and np.array_equal(a, b), text
        reads, refs = got.aligned_columns()
        assert [None if v < 0 else v for v in reads.tolist()] == \
            [q for q, _ in want.aligned_pairs], text
        assert [None if v < 0 else v for v in refs.tolist()] == \
            [r for _, r in want.aligned_pairs], text


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_indel_kmer_span_filter_keeps_every_span(k):
    """``_span_tokens`` drops only columns that cannot reach a span: the
    JAX package's span finder on all columns yields what the port's
    yields on the kept ones."""
    from nanopore_tpu.analyses.kmer import IndelKmerAnalysis as JaxIndelKmer
    from nanopore_tpu.io.sam import SamRecord as JaxRecord
    from nanopore_tpu_torch.analyses.kmer import IndelKmerAnalysis
    from nanopore_tpu_torch.io.sam import SamRecord, parse_cigar

    for text, pos in _random_cigars(10 + k, 500):
        cigar = parse_cigar(text)
        pairs = JaxRecord(qname="r", flag=0, rname="x", pos=pos,
                          cigar=cigar, seq="A").aligned_pairs
        cols = SamRecord(qname="r", flag=0, rname="x", pos=pos, cigar=cigar,
                         seq="A").aligned_columns()
        for col, full in zip(cols, ([q for q, _ in pairs],
                                    [r for _, r in pairs])):
            want = list(JaxIndelKmer._indel_kmer_spans(full, k))
            got = list(IndelKmerAnalysis._indel_kmer_spans(
                IndelKmerAnalysis._span_tokens(col, k), k))
            assert got == want, (text, k)


def test_fastq_read_matches_the_jax_reader(tmp_path):
    from nanopore_tpu.io.seqio import fastq_read as jax_fastq_read
    from nanopore_tpu_torch.io.seqio import fastq_read

    path = tmp_path / "r.fq"
    path.write_text("@a x\nACGT\n+\n!#I~\n@b\nAC\n+\n*\n\n@c\n\n+\n\n")
    assert list(fastq_read(str(path))) == list(jax_fastq_read(str(path)))


@pytest.mark.parametrize("seed", [3, 4])
def test_band_helpers_match_the_jax_package(seed):
    """``band_offsets_from_cigar`` and ``path_band_indices`` (vectorised
    in the port) against the JAX package's on random guide cigars."""
    from nanopore_tpu.ops.pairhmm import band_offsets_from_cigar as jax_band
    from nanopore_tpu.ops.posteriors import path_band_indices as jax_path
    from nanopore_tpu_torch.ops.pairhmm import band_offsets_from_cigar
    from nanopore_tpu_torch.ops.posteriors import path_band_indices

    rng = np.random.default_rng(seed)
    checked = 0
    for _ in range(400):
        cigar = [(int(rng.choice([0, 0, 0, 1, 2, 3, 4, 7, 8])),
                  int(rng.choice([1, 2, 3, 7, 20])))
                 for _ in range(rng.integers(0, 30))]
        m = sum(l for op, l in cigar if op in (0, 1, 7, 8))
        n = sum(l for op, l in cigar if op in (0, 2, 3, 7, 8))
        for W in (8, 32, 64):
            try:
                want = jax_band(cigar, m, n, W)
            except ValueError:
                with pytest.raises(ValueError):
                    band_offsets_from_cigar(cigar, m, n, W)
                continue
            got = band_offsets_from_cigar(cigar, m, n, W)
            assert got.dtype == want.dtype and np.array_equal(got, want)
            (pb, count), (jpb, jcount) = (path_band_indices(cigar, want, W),
                                          jax_path(cigar, want, W))
            assert count == jcount and np.array_equal(pb, jpb)
            assert pb.dtype == jpb.dtype
            checked += 1
    assert checked > 500
