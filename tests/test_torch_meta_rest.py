"""The port's ``CoverageDepth``, ``CustomTrackAssemblyHub`` and
``MarginAlignMetaAnalysis`` against the JAX package's, on the CPU.

* ``CoverageDepth`` and ``CustomTrackAssemblyHub`` run over the same
  experiments in both packages: the ``LastParams`` and
  ``LastParamsChain`` experiments of a JAX pipeline run on
  tests/test_pipeline.py's working directory, and a hand-made one on a
  two-contig reference with an N run, secondaries, an unmapped read and
  a depth jump.  Every file they write is held byte for byte against
  the JAX package's: depth and statistics text, the 2bit genome, the
  sorted BAM tracks and their ``.bai``, the hub's text files, and the
  depth plots (PDF, ``SOURCE_DATE_EPOCH`` pinned; they draw only where
  matplotlib is present).
* ``MarginAlignMetaAnalysis`` runs over experiment directories holding
  seeded ``analysis_MarginAlignSnpCaller/marginaliseConsensus.xml``
  files (two read types, two references, two mappers, callers at
  coverages 10, 30, 60 and above 1000, held-out shares in every
  quantisation bucket and at 0, one experiment without the file):
  its tables, ROC TSVs and ROC plots byte for byte; then
  ``variant_table`` turns both ``marginAlignSquares.txt`` into the same
  LaTeX.  No tolerance is needed: both packages run the same host
  arithmetic in the same order.
"""

import os
import shutil
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from nanopore_tpu.io.sam import SamRecord as JaxSamRecord
from nanopore_tpu.io.sam import SamWriter as JaxSamWriter
from nanopore_tpu.io.sam import parse_cigar as jax_parse_cigar
from nanopore_tpu.io.xmlio import pretty_xml
from nanopore_tpu.meta import ALL_META_ANALYSES as JAX_META
from nanopore_tpu.pipeline import Experiment as JaxExperiment
from nanopore_tpu.pipeline import PipelineConfig as JaxConfig
from nanopore_tpu.pipeline import run_pipeline as jax_run_pipeline
from nanopore_tpu.scripts import variant_table as jax_variant_table
from nanopore_tpu_torch.meta import ALL_META_ANALYSES
from nanopore_tpu_torch.pipeline import Experiment
from nanopore_tpu_torch.scripts import variant_table
from test_pipeline import working_dir  # noqa: F401  (a fixture)
from test_torch_scripts import same_files


def run_both(name, experiments, tmp_path, analyses=()):
    """``name``'s class of each package over the same experiments (as
    (fastq, read type, reference, mapper, dir) tuples) into
    ``tmp_path/port`` and ``tmp_path/jax``; returns the file names."""
    outs = []
    for tag, registry, exp_cls in (("port", ALL_META_ANALYSES, Experiment),
                                   ("jax", JAX_META, JaxExperiment)):
        out = tmp_path / tag
        os.makedirs(out)
        registry[name](str(out), [exp_cls(*e) for e in experiments],
                       list(analyses)).run()
        outs.append(out)
    return same_files(*outs)


def hand_made_experiment(base):
    """Two contigs (one with an N run), records on both strands and
    contigs, a secondary, an unmapped read, a stack of reads that makes
    a depth jump."""
    rng = np.random.default_rng(13)
    os.makedirs(base)
    c1 = "".join(rng.choice(list("ACGT"), 900))
    c2 = "".join(rng.choice(list("ACGT"), 300)) + "N" * 40 + "".join(
        rng.choice(list("ACGT"), 200))
    fa = os.path.join(base, "two.fa")
    with open(fa, "w") as fh:
        fh.write(">chrA first\n%s\n>chrB\n%s\n" % (c1, c2))
    fq = os.path.join(base, "reads.fq")
    exp_dir = os.path.join(base, "experiment_reads.fq_two.fa_Demo")
    os.makedirs(exp_dir)
    recs = []
    for i in range(14):
        name = "r%d" % i
        if i == 13:
            recs.append(JaxSamRecord(qname=name, seq="ACGT"))
            continue
        contig, seq = ("chrA", c1) if i % 3 else ("chrB", c2)
        pos = 100 if i < 6 else int(rng.integers(0, len(seq) - 120))
        cigar = "5S40M2I30M3D20M" if i % 2 else "60M4D30M"
        flag = (16 if i % 4 == 1 else 0) | (256 if i == 7 else 0)
        read_len = sum(n for op, n in jax_parse_cigar(cigar)
                       if op in (0, 1, 4))
        recs.append(JaxSamRecord(
            qname=name, flag=flag, rname=contig, pos=pos, mapq=60,
            cigar=jax_parse_cigar(cigar),
            seq="".join(rng.choice(list("ACGT"), read_len))))
    with open(fq, "w") as fh:
        for r in recs:
            fh.write("@%s\n%s\n+\n%s\n" % (r.qname, r.seq, "I" * len(r.seq)))
    with JaxSamWriter(os.path.join(exp_dir, "mapping.sam"),
                      {"chrA": len(c1), "chrB": len(c2)}) as w:
        for r in recs:
            w.write(r)
    # an experiment whose mapping is missing: both classes skip it
    missing = os.path.join(base, "experiment_reads.fq_two.fa_Missing")
    os.makedirs(missing)
    return [(fq, "2d", fa, "Demo", exp_dir),
            (fq, "2d", fa, "Missing", missing)]


@pytest.fixture(scope="module")
def experiments(working_dir, tmp_path_factory):  # noqa: F811
    base = tmp_path_factory.mktemp("meta_rest")
    wd = base / "wd"
    for sub in ("readFastqFiles", "referenceFastaFiles"):
        shutil.copytree(os.path.join(working_dir, sub), wd / sub)
    out = jax_run_pipeline(str(wd), JaxConfig(
        mappers=["LastParams", "LastParamsChain"], analyses=[],
        meta_analyses=[], max_workers=1))
    fq = os.path.join(out, "processedReadFastqFiles", "2d", "reads.fq")
    fa = os.path.join(out, "processedReferenceFastaFiles", "ref.fa")
    exps = []
    for mapper in ("LastParams", "LastParamsChain"):
        d = os.path.join(out, "analysis_2d",
                         "experiment_reads.fq_ref.fa_" + mapper)
        assert os.path.exists(os.path.join(d, "mapping.sam"))
        exps.append((fq, "2d", fa, mapper, d))
    return exps + hand_made_experiment(str(base / "hand"))


def test_coverage_depth_files_equal(experiments, tmp_path, monkeypatch):
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    names = run_both("CoverageDepth", experiments, tmp_path)
    for exp in ("experiment_reads.fq_ref.fa_LastParams",
                "experiment_reads.fq_two.fa_Demo"):
        assert exp + "_Depth.txt" in names and exp + "_Stats.out" in names
    assert not any("Missing" in n for n in names)
    stats = open(tmp_path / "port" /
                 "experiment_reads.fq_two.fa_Demo_Stats.out").read()
    assert len(stats.splitlines()) > 1  # the stack at 100 is a jump


def test_assembly_hub_files_equal(experiments, tmp_path):
    names = run_both("CustomTrackAssemblyHub", experiments, tmp_path)
    for genome, track in (("ref", "experiment_reads.fq_ref.fa_LastParams"),
                          ("two", "experiment_reads.fq_two.fa_Demo")):
        for f in ("hub.txt", "genomes.txt"):
            assert os.path.join("hub_" + genome, f) in names
        for f in (genome + ".2bit", "trackDb.txt", "groups.txt",
                  track + ".bam", track + ".bam.bai"):
            assert os.path.join("hub_" + genome, genome, f) in names


# ---- MarginAlignMetaAnalysis ------------------------------------------------ #

CALLERS = ["marginAlignMaxExpectedSnpCalls_cactus",
           "marginAlignMaxLikelihoodSnpCalls_trained"]


def write_consensus_xml(path, rng):
    node = ET.Element("marginAlignComparison")
    for tag in CALLERS:
        for coverage in (10, 30, 60, 1_000_000):
            for held_out in (0, 3, 30, 80, 150, 300):
                for replicate in range(2):
                    non_held = 1000 - held_out
                    recall = np.sort(rng.random(101))[::-1]
                    recall[int(rng.integers(60, 101)):] = 0.0
                    precision = rng.random(101)
                    ET.SubElement(node, tag, {
                        "coverage": str(coverage),
                        "actualCoverage": repr(float(rng.uniform(5, 80))),
                        "replicate": str(replicate),
                        "totalHeldOut": str(held_out),
                        "totalNonHeldOut": str(non_held),
                        "recall": repr(float(recall[0])),
                        "precision": repr(float(precision[0])),
                        "totalNoCalls": str(int(rng.integers(0, 50))),
                        "recallByProbability": " ".join(
                            map(str, recall.tolist())),
                        "precisionByProbability": " ".join(
                            map(str, precision.tolist())),
                    })
    os.makedirs(os.path.dirname(path))
    with open(path, "w") as fh:
        fh.write(pretty_xml(node))


@pytest.fixture(scope="module")
def snp_experiments(tmp_path_factory):
    base = tmp_path_factory.mktemp("margin_meta")
    rng = np.random.default_rng(17)
    exps = []
    for read_type in ("2d", "template"):
        fq = str(base / ("%s.fq" % read_type))
        for ref in ("refA.fa", "refB.fa"):
            for mapper in ("LastParams", "LastParamsRealignEm"):
                d = base / ("experiment_%s_%s_%s" % (read_type, ref, mapper))
                os.makedirs(d)
                exps.append((fq, read_type, str(base / ref), mapper, str(d)))
                if (read_type, ref, mapper) == ("template", "refB.fa",
                                                "LastParams"):
                    continue  # an experiment without the caller's file
                write_consensus_xml(str(
                    d / "analysis_MarginAlignSnpCaller"
                    / "marginaliseConsensus.xml"), rng)
    return exps


def test_margin_align_meta_files_equal(snp_experiments, tmp_path,
                                       monkeypatch):
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    names = run_both("MarginAlignMetaAnalysis", snp_experiments, tmp_path,
                     analyses=["MarginAlignSnpCaller"])
    for f in ("marginAlignAll.txt", "marginAlignSquares.txt",
              "2d_LastParams.tsv", "template_LastParamsRealignEm.tsv"):
        assert f in names
    rows = open(tmp_path / "port" / "marginAlignAll.txt").read().splitlines()
    covs = {r.split("\t")[4] for r in rows[1:]}
    assert covs == {"30", "60", "ALL"}  # coverage 10 dropped, >1000 ALL
    props = {r.split("\t")[3] for r in rows[1:]}
    assert props == {"0.01", "0.05", "0.1", "0.2"}
    for tag, mod in (("port", variant_table), ("jax", jax_variant_table)):
        mod.main([str(tmp_path / tag / "table.tex"),
                  str(tmp_path / tag / "marginAlignSquares.txt")])
    tex = open(tmp_path / "port" / "table.tex").read()
    assert tex == open(tmp_path / "jax" / "table.tex").read()
    squares = open(tmp_path / "port" / "marginAlignSquares.txt").readlines()
    # one table a (read type, mapper, caller, held-out share, reference)
    assert tex.count("\\begin{tabular}") == len(squares) - 1 == 56
