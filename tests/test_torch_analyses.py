"""The port's posterior analyses vs the JAX package's, on the CPU.

* ``AlignmentUncertainty`` on the small mapped experiment of
  tests/test_analyses.py: the XML's ``alignedPairsInCigar`` identical and
  each per-read average posterior within 1e-4 of the JAX package's.
* ``MarginAlignSnpCaller`` on the mutated-reference experiment of
  tests/test_snp_caller.py:
  - ``_posteriors_for_hmm`` per record and per model against the JAX
    package's (rtol 1e-3, atol 2e-3: the port bins the kernel's exp-mode
    retire stream, pulled as f16; the JAX package on the CPU scans the
    XLA forward_backward band);
  - fed the JAX package's posterior matrices, the port writes the JAX
    package's ``marginaliseConsensus.xml`` byte for byte;
  - the port's own end-to-end XML passes the assertions of
    tests/test_snp_caller.py::TestMarginAlignSnpCaller;
  - a small ``split_k`` changes the matrices only as
    tests/test_snp_caller.py::TestAnchorSplitPosteriors allows.
"""

import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from nanopore_tpu.align.chain_sam import chain_sam_file
from nanopore_tpu.analyses.alignment_uncertainty import (
    AlignmentUncertainty as JaxUncertainty,
)
from nanopore_tpu.analyses.common import ExperimentData as JaxData
from nanopore_tpu.analyses.snp_caller import (
    HMM_TYPES,
    MarginAlignSnpCaller as JaxSnpCaller,
)
from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.analyses.alignment_uncertainty import (
    trained_hmm_path as jax_hmm_path,
)
from nanopore_tpu.io.encoding import decode, reverse_complement
from nanopore_tpu.io.seqio import fasta_write, fastq_write
from nanopore_tpu.mapping.engine import MapperConfig, MappingEngine
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.analyses import (
    AlignmentUncertainty,
    Analysis,
    MarginAlignSnpCaller,
)
from nanopore_tpu_torch.analyses.alignment_uncertainty import trained_hmm_path
from nanopore_tpu_torch.analyses.common import ExperimentData


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """tests/test_analyses.py's experiment: two noisy reads on both
    strands and one random read, mapped by the JAX engine."""
    tmp = tmp_path_factory.mktemp("torch_exp")
    rng = np.random.default_rng(11)
    ref = decode(rng.integers(0, 4, 1200).astype(np.int8))
    fa = str(tmp / "ref.fa")
    fasta_write(fa, "REF1", ref)

    def noisy(seq):
        out = []
        for ch in seq:
            r = rng.random()
            if r < 0.04:
                continue
            if r < 0.08:
                out.append("ACGT"[rng.integers(0, 4)])
            out.append(ch if rng.random() > 0.05
                       else "ACGT"[rng.integers(0, 4)])
        return "".join(out)

    reads = {
        "channel_3_read_1": noisy(ref[100:600]),
        "channel_7_read_2": reverse_complement(noisy(ref[400:1000])),
        "channel_9_read_3": decode(rng.integers(0, 4, 300).astype(np.int8)),
    }
    fq = str(tmp / "reads.fq")
    with open(fq, "w") as fh:
        for name, seq in reads.items():
            fastq_write(fh, name, seq, [20] * len(seq))
    sam = str(tmp / "mapping.sam")
    MappingEngine({"REF1": ref}, MapperConfig()).map_fastq(fq, sam)
    return {"fa": fa, "fq": fq, "sam": sam, "tmp": tmp}


@pytest.fixture(scope="module")
def snp_experiment(tmp_path_factory):
    """tests/test_snp_caller.py's experiment: reads from the TRUE
    reference, mapped and chained against a ~3 % mutated one."""
    tmp = tmp_path_factory.mktemp("torch_snp")
    rng = np.random.default_rng(33)
    true_ref = decode(rng.integers(0, 4, 600).astype(np.int8))
    mutated = list(true_ref)
    n_mut = 0
    for i in range(len(true_ref)):
        if rng.random() < 0.03:
            alt = "ACGT"[rng.integers(0, 4)]
            if alt != true_ref[i]:
                mutated[i] = alt
                n_mut += 1
    mutated_ref = "".join(mutated)
    assert n_mut > 5
    fa = str(tmp / "ref.fa")
    fasta_write(fa, "REF", mutated_ref)
    with open(fa + "_Index.txt", "w") as fh:
        fasta_write(fh, "REF", true_ref)
        fasta_write(fh, "REF_mutated", mutated_ref)

    def noisy(seq):
        out = []
        for ch in seq:
            r = rng.random()
            if r < 0.02:
                continue
            if r < 0.04:
                out.append("ACGT"[rng.integers(0, 4)])
            out.append(ch if rng.random() > 0.03
                       else "ACGT"[rng.integers(0, 4)])
        return "".join(out)

    fq = str(tmp / "reads.fq")
    with open(fq, "w") as fh:
        for i in range(6):
            fastq_write(fh, "read_%d" % i, noisy(true_ref), None)
    raw_sam = str(tmp / "raw.sam")
    MappingEngine({"REF": mutated_ref}, MapperConfig()).map_fastq(fq, raw_sam)
    sam = str(tmp / "mapping.sam")
    chain_sam_file(raw_sam, sam, fq, fa)
    return {"fa": fa, "fq": fq, "sam": sam, "tmp": tmp, "n_mut": n_mut}


def _outdir(tmp, name):
    d = str(tmp / name)
    os.makedirs(d, exist_ok=True)
    return d


def test_trained_models_are_the_jax_package_files():
    for name in ("blasr_hmm_0.txt", "blasr_hmm_20.txt", "blasr_hmm_40.txt"):
        with open(trained_hmm_path(name)) as a, open(jax_hmm_path(name)) as b:
            assert a.read() == b.read()


def test_alignment_uncertainty_matches_jax(experiment):
    args = (experiment["fq"], "2d", experiment["fa"], experiment["sam"])
    jdir = _outdir(experiment["tmp"], "jax_uncert")
    JaxUncertainty(*args, jdir).execute()
    pdir = _outdir(experiment["tmp"], "port_uncert")
    AlignmentUncertainty(*args, pdir, device="cpu").execute()
    assert Analysis.is_finished(pdir)
    want = ET.parse(os.path.join(jdir, "alignmentUncertainty.xml")).getroot()
    got = ET.parse(os.path.join(pdir, "alignmentUncertainty.xml")).getroot()
    assert got.attrib["alignedPairsInCigar"] == \
        want.attrib["alignedPairsInCigar"]
    key = "averagePosteriorMatchProbabilitesPerRead"
    g = np.array(got.attrib[key].split(","), float)
    w = np.array(want.attrib[key].split(","), float)
    assert len(g) == len(w) >= 2
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    avg = float(got.attrib["averagePosteriorMatchProbability"])
    assert avg == pytest.approx(
        float(want.attrib["averagePosteriorMatchProbability"]), abs=1e-4)
    assert 0.3 < avg <= 1.0


def _models(cls, path):
    return {
        "cactus": cls.default(),
        "trained_0": cls.load(path("blasr_hmm_0.txt")),
        "trained_20": cls.load(path("blasr_hmm_20.txt")),
        "trained_40": cls.load(path("blasr_hmm_40.txt")),
    }


class _Recording(MarginAlignSnpCaller):
    """The port's caller, keeping each model's matrices as it goes."""

    recorded: list

    def _posteriors_for_hmm(self, data, model):
        out = super()._posteriors_for_hmm(data, model)
        self.recorded.append(out)
        return out


@pytest.fixture(scope="module")
def jax_posteriors(snp_experiment):
    e = snp_experiment
    data = JaxData(e["fq"], e["fa"], e["sam"])
    caller = JaxSnpCaller(e["fq"], "2d", e["fa"], e["sam"], str(e["tmp"]))
    models = _models(JaxModel, jax_hmm_path)
    return {h: caller._posteriors_for_hmm(data, models[h]) for h in HMM_TYPES}


@pytest.fixture(scope="module")
def port_run(snp_experiment):
    e = snp_experiment
    outdir = _outdir(e["tmp"], "port_snp")
    caller = _Recording(e["fq"], "2d", e["fa"], e["sam"], outdir,
                        device="cpu")
    caller.batch_size = 8  # one batch per model: the CPU path is per diagonal
    caller.recorded = []
    caller.execute()
    return {"xml": os.path.join(outdir, "marginaliseConsensus.xml"),
            "posteriors": dict(zip(HMM_TYPES, caller.recorded))}


def test_snp_posteriors_match_jax_per_record_and_model(port_run,
                                                       jax_posteriors):
    for hmm in HMM_TYPES:
        got, want = port_run["posteriors"][hmm], jax_posteriors[hmm]
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=2e-3)


def test_snp_calls_from_jax_posteriors_write_the_jax_xml(
        snp_experiment, jax_posteriors, monkeypatch):
    e = snp_experiment
    args = (e["fq"], "2d", e["fa"], e["sam"])

    def replay(self, data, model):
        return jax_posteriors[HMM_TYPES[self.calls.pop(0)]]

    texts = []
    for cls, kwargs in ((JaxSnpCaller, {}),
                        (MarginAlignSnpCaller, {"device": "cpu"})):
        monkeypatch.setattr(cls, "_posteriors_for_hmm", replay)
        outdir = _outdir(e["tmp"], "replay_" + cls.__module__.split(".")[0])
        caller = cls(*args, outdir, **kwargs)
        caller.calls = list(range(len(HMM_TYPES)))
        caller.execute()
        assert caller.calls == []
        with open(os.path.join(outdir, "marginaliseConsensus.xml"),
                  "rb") as fh:
            texts.append(fh.read())
    assert texts[0] == texts[1]


def test_snp_caller_end_to_end_calls_injected_snps(snp_experiment, port_run):
    root = ET.parse(port_run["xml"]).getroot()
    assert root.tag == "marginAlignComparison"
    nodes = list(root)
    assert len(nodes) == 4 * 4 * (1 + 4 * 3)
    best = {}
    for node in nodes:
        if node.attrib["coverage"] == "1000000":
            best[node.tag] = float(node.attrib["fScore"])
    assert len(best) == 16
    assert max(best.values()) > 0.5, best
    node = nodes[0]
    assert int(node.attrib["totalHeldOut"]) == snp_experiment["n_mut"]
    assert float(node.attrib["actualCoverage"]) > 1.0
    assert len(node.attrib["recallByProbability"].split()) == 101


def test_snp_posteriors_split_match_unsplit(snp_experiment, port_run):
    e = snp_experiment
    data = ExperimentData(e["fq"], e["fa"], e["sam"])
    caller = MarginAlignSnpCaller(e["fq"], "2d", e["fa"], e["sam"],
                                  str(e["tmp"]), device="cpu", split_k=700)
    caller.batch_size = 16
    split = caller._posteriors_for_hmm(data, PairHmmModel.default())
    plain = port_run["posteriors"]["cactus"]
    assert len(plain) == len(split)
    for a, b in zip(plain, split):
        assert a.shape == b.shape
        diff = np.abs(a - b)
        assert abs(a.sum() - b.sum()) < 0.05 * max(a.sum(), 1.0)
        assert (diff.max(axis=1) > 0.05).sum() <= 10


def test_snp_caller_requires_global_records(experiment):
    caller = MarginAlignSnpCaller(experiment["fq"], "2d", experiment["fa"],
                                  experiment["sam"], str(experiment["tmp"]),
                                  device="cpu")
    data = ExperimentData(experiment["fq"], experiment["fa"],
                          experiment["sam"])
    assert any(rec.pos != 0 for rec in data.records)
    with pytest.raises(ValueError, match="global"):
        caller._posteriors_for_hmm(data, PairHmmModel.default())
