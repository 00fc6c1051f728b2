"""The port's scheduler, pipeline and ``run`` subcommand, on the CPU.

* ``runtime/scheduler.py`` on the four cases of tests/test_pipeline.py.
* The pipeline, port (``device="cpu"``) against the JAX package, on
  tests/test_pipeline.py's small working directory with the mappers,
  analyses and meta-analyses of its ``test_full_pipeline``
  (``EmOptions(trials=1, iterations=3, band_width=48)``, which the port
  lays into its W = 64 layout):
  - the same tree of files, the same tasks, every one done;
  - ``mapping.sam`` equal per experiment; a realigned cigar may differ
    only where the Pallas kernel in interpret mode decodes the port's
    (tests/test_torch_chain_realign.py);
  - where two SAMs are equal, every analysis data file byte-identical;
    where all are, every meta-analysis data file too; the EM-trained
    ``hmm.txt`` files and what ``Hmm`` and ``HmmMetaAnalysis`` write
    from them within 3e-5 relative (the EM bar), a number printed to a
    few decimals within its last digit;
  - the resumed run skips every task.
* ``run --device cpu`` through the CLI, with a ``torch.profiler`` trace;
  ``run`` without a card raises; an unknown name raises ``ValueError``
  before any task runs, and a two-process environment joins a gloo
  process group from its three variables first.
* ``CoverageDepth``, ``MarginAlignMetaAnalysis`` and
  ``CustomTrackAssemblyHub`` in the pipeline beside ``CoverageSummary``:
  the files of the JAX pipeline.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from nanopore_tpu.align.chain_sam import chain_sam_file as jax_chain_sam_file
from nanopore_tpu.align.em import EmOptions as JaxEmOptions
from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.mapping.runner import run_mapper as jax_run_mapper
from nanopore_tpu.pipeline import PipelineConfig as JaxConfig
from nanopore_tpu.pipeline import run_pipeline as jax_run_pipeline
from nanopore_tpu_torch import cli
from nanopore_tpu_torch.align.em import EmOptions
from nanopore_tpu_torch.mapping.presets import MAPPER_REGISTRY
from nanopore_tpu_torch.pipeline import PipelineConfig, run_pipeline
from nanopore_tpu_torch.runtime.scheduler import Scheduler, SchedulerError
from test_pipeline import working_dir  # noqa: F401  (a fixture)
from test_torch_chain_realign import (
    assert_sam_equal_up_to_pallas_ties,
    sam_records,
)

MAPPERS = ["LastParamsChain", "LastParamsRealignEm"]
ANALYSES = ["GlobalCoverage", "Substitutions", "Indels", "Hmm"]
META = ["CoverageSummary", "UnmappedLengthDistributionAnalysis",
        "ComparePerReadMappabilityByMapper", "HmmMetaAnalysis"]
EM = dict(trials=1, iterations=3, band_width=48)
EM_RTOL = 3e-5
PLOTS = (".pdf", ".png")
# files of the EM-trained model and of what reads it
EM_FILE = re.compile(
    r"(^|/)(hmm\.txt.*|analysis_Hmm/.*|metaAnalysis_HmmMetaAnalysis/.*)$")


# ---- the scheduler: tests/test_pipeline.py::TestScheduler ------------ #

def test_scheduler_ordering_and_stats(tmp_path):
    order = []
    s = Scheduler(max_workers=2)
    s.add_task("a", lambda: order.append("a"))
    s.add_task("b", lambda: order.append("b"), deps=["a"])
    s.add_task("c", lambda: order.append("c"), deps=["a"])
    s.add_task("d", lambda: order.append("d"), deps=["b", "c"])
    stats = str(tmp_path / "stats.json")
    results = s.run(stats_path=stats)
    assert order[0] == "a" and order[-1] == "d"
    assert all(r.status == "done" for r in results.values())
    assert set(json.load(open(stats))) == {"a", "b", "c", "d"}


def test_scheduler_skip_if():
    ran = []
    s = Scheduler(max_workers=1)
    s.add_task("x", lambda: ran.append(1), skip_if=lambda: True)
    assert s.run()["x"].status == "skipped"
    assert not ran


def test_scheduler_failure_propagates():
    ran = []

    def boom():
        raise RuntimeError("kaboom")

    s = Scheduler(max_workers=2)
    s.add_task("bad", boom, retries=2)
    s.add_task("child", lambda: ran.append(1), deps=["bad"])
    s.add_task("independent", lambda: ran.append(2))
    with pytest.raises(SchedulerError) as exc_info:
        s.run()
    assert {r.name for r in exc_info.value.failed} == {"bad", "child"}
    assert 2 in ran and 1 not in ran


def test_scheduler_retries():
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) < 2:
            raise RuntimeError("transient")

    s = Scheduler(max_workers=1)
    s.add_task("f", flaky, retries=3)
    results = s.run()
    assert results["f"].status == "done" and results["f"].attempts == 2


# ---- the pipeline, port against the JAX package ---------------------- #

def copy_inputs(src, dst):
    for sub in ("readFastqFiles", "referenceFastaFiles"):
        shutil.copytree(os.path.join(src, sub), os.path.join(dst, sub))
    return str(dst)


def tree(out) -> list:
    return sorted(
        os.path.relpath(os.path.join(root, f), out)
        for root, _, files in os.walk(out) for f in files
    )


def stats(out, wd) -> dict:
    """pipeline_stats.json, its task names relative to the working dir."""
    data = json.load(open(os.path.join(out, "pipeline_stats.json")))
    return {k.replace(wd, "<wd>"): v for k, v in data.items()}


@pytest.fixture(scope="module")
def runs(working_dir, tmp_path_factory):  # noqa: F811
    """Both pipelines, each on its own copy of the inputs, reached
    through one path: a link pointed at the JAX package's copy for its
    run, then at the port's (where it stays, for the rerun and the
    resumed run).  The unmapped meta-analyses keep the reads in a set
    whose order follows the hashes of the reads' FASTQ paths, so the two
    runs see the same path strings and write their rows in one order."""
    base = tmp_path_factory.mktemp("torch_pipeline")
    jdir = copy_inputs(working_dir, base / "jax")
    pdir = copy_inputs(working_dir, base / "port")
    wd = str(base / "wd")
    os.symlink(jdir, wd)
    jout = jax_run_pipeline(wd, JaxConfig(
        mappers=MAPPERS, analyses=ANALYSES, meta_analyses=META,
        max_workers=2, em_options=JaxEmOptions(**EM)))
    os.remove(wd)
    os.symlink(pdir, wd)
    pout = run_pipeline(wd, PipelineConfig(
        mappers=MAPPERS, analyses=ANALYSES, meta_analyses=META,
        max_workers=2, em_options=EmOptions(**EM), device="cpu"))
    return {"jwd": wd, "pwd": wd, "jout": jdir + jout[len(wd):],
            "pout": pout, "base": base}


def test_pipeline_writes_the_jax_tree_and_tasks(runs):
    assert tree(runs["pout"]) == tree(runs["jout"])
    ps, js = stats(runs["pout"], runs["pwd"]), stats(runs["jout"],
                                                     runs["jwd"])
    assert sorted(ps) == sorted(js)
    assert len(ps) == len(MAPPERS) * (1 + len(ANALYSES)) + len(META)
    assert all(v["status"] == "done" and v["attempts"] == 1
               for v in ps.values()), ps


def experiment_dirs(out):
    base = os.path.join(out, "analysis_2d")
    return {d: os.path.join(base, d) for d in sorted(os.listdir(base))}


def jax_chained(runs, fq, fa):
    """The chained guides the JAX package's realign stage started from."""
    d = runs["base"]
    mapped, chained = str(d / "j_map.sam"), str(d / "j_chain.sam")
    if not os.path.exists(chained):
        jax_run_mapper("LastParams", fq, "2d", fa, mapped)
        jax_chain_sam_file(mapped, chained, fq, fa)
    return chained


def equal_sams(runs) -> dict:
    """{experiment: whether the two mapping.sam are byte-identical};
    a differing realigned SAM must differ only by Pallas ties.  Checked
    once a module."""
    if "same" in runs:
        return runs["same"]
    jexp, pexp = experiment_dirs(runs["jout"]), experiment_dirs(runs["pout"])
    jout = runs["jout"]
    fq = os.path.join(jout, "processedReadFastqFiles", "2d", "reads.fq")
    fa = os.path.join(jout, "processedReferenceFastaFiles", "ref.fa")
    same = {}
    for name, jdir in jexp.items():
        jsam = os.path.join(jdir, "mapping.sam")
        psam = os.path.join(pexp[name], "mapping.sam")
        same[name] = open(psam).read() == open(jsam).read()
        if not same[name]:
            mapper = name.rsplit("_", 1)[1]
            spec = MAPPER_REGISTRY[mapper]
            assert spec.post == "realign_em", name
            assert_sam_equal_up_to_pallas_ties(
                psam, jsam, jax_chained(runs, fq, fa), fa,
                JaxModel.load(os.path.join(jdir, "hmm.txt")),
                spec.gap_gamma, spec.match_gamma, spec.band_width)
    runs["same"] = same
    return same


def test_mapping_sams_equal(runs):
    same = equal_sams(runs)
    assert same["experiment_reads.fq_ref.fa_LastParamsChain"]
    for name, pdir in experiment_dirs(runs["pout"]).items():
        assert sam_records(os.path.join(pdir, "mapping.sam"))


def _number(tok):
    try:
        return float(tok)
    except ValueError:
        return None


def assert_close_text(got: str, want: str, what: str) -> None:
    """Token by token: words equal, numbers within EM_RTOL relative or
    within the last printed digit of the JAX package's number."""
    gt, wt = re.split(r"([\s,\"=<>]+)", got), re.split(r"([\s,\"=<>]+)", want)
    assert len(gt) == len(wt), what
    for g, w in zip(gt, wt):
        gn, wn = _number(g), _number(w)
        if wn is None or gn is None or not np.isfinite(wn):
            assert g == w, (what, g, w)
            continue
        frac = w.split(".")[1] if "." in w and "e" not in w.lower() else ""
        atol = 10.0 ** -len(frac) if 0 < len(frac) < 7 else 0.0
        assert abs(gn - wn) <= max(EM_RTOL * abs(wn), atol), (what, g, w)


def jax_rerun(runs, same) -> str:
    """The JAX package's analyses on the port's SAM of each experiment
    whose SAM differs (a Pallas tie), and its meta-analyses over the
    port's experiments if any does, into a tree beside the runs."""
    import nanopore_tpu.analyses as jax_analyses
    from nanopore_tpu.meta import ALL_META_ANALYSES as JAX_META
    from nanopore_tpu.pipeline import Experiment as JaxExperiment

    out = str(runs["base"] / "rerun")
    if os.path.exists(out):
        return out
    pout = runs["pout"]
    fq = os.path.join(pout, "processedReadFastqFiles", "2d", "reads.fq")
    fa = os.path.join(pout, "processedReferenceFastaFiles", "ref.fa")
    experiments = []
    for name, pdir in experiment_dirs(pout).items():
        experiments.append(JaxExperiment(fq, "2d", fa, name.rsplit("_", 1)[1],
                                         pdir))
        if same[name]:
            continue
        for a in ANALYSES:
            d = os.path.join(out, "analysis_2d", name, "analysis_" + a)
            os.makedirs(d)
            jax_analyses.ALL_ANALYSES[a](
                fq, "2d", fa, os.path.join(pdir, "mapping.sam"), d).execute()
    if not all(same.values()):
        for m in META:
            d = os.path.join(out, "metaAnalysis_" + m)
            os.makedirs(d)
            JAX_META[m](d, experiments, ANALYSES).run()
    return out


def test_data_files_equal(runs):
    """Every data file equals the JAX pipeline's (the EM's within its
    bar); where an experiment's SAM differs by a Pallas tie, its
    analyses (and then every meta-analysis) must equal what the JAX
    package's analyses write from the port's SAM."""
    same = equal_sams(runs)
    jout, pout = runs["jout"], runs["pout"]
    rerun = jax_rerun(runs, same)
    compared = close = 0
    for rel in tree(jout):
        if rel.endswith(PLOTS) or rel == "pipeline_stats.json":
            continue
        got = open(os.path.join(pout, rel), "rb").read()
        want = open(os.path.join(jout, rel), "rb").read()
        if EM_FILE.search(rel.replace(os.sep, "/")):
            assert_close_text(got.decode(), want.decode(), rel)
            close += 1
        alt = os.path.join(rerun, rel)
        if os.path.exists(alt):
            want = open(alt, "rb").read()
        elif EM_FILE.search(rel.replace(os.sep, "/")):
            continue
        elif rel.endswith("mapping.sam"):
            continue  # equal_sams compared them
        assert got == want, rel
        compared += 1
    assert compared > 30 and close >= 10, (compared, close)


def test_resume_skips_every_task(runs):
    pout = run_pipeline(runs["pwd"], PipelineConfig(
        mappers=MAPPERS, analyses=ANALYSES, meta_analyses=[],
        max_workers=2, em_options=EmOptions(**EM), device="cpu"))
    data = stats(pout, runs["pwd"])
    assert len(data) == len(MAPPERS) * (1 + len(ANALYSES))
    for name, entry in data.items():
        assert entry["status"] == "skipped", (name, entry)


# ---- the run subcommand and its refusals ------------------------------ #

def test_cli_run_on_the_cpu_with_a_profile(working_dir, tmp_path,  # noqa: F811
                                           monkeypatch):
    wd = copy_inputs(working_dir, tmp_path / "wd")
    monkeypatch.setenv("NANOPORE_TPU_PROFILE", str(tmp_path / "prof"))
    assert cli.main(["run", wd, "--device", "cpu", "--mappers",
                     "LastParams", "--analyses", "Substitutions,KmerAnalysis",
                     "--meta-analyses", "CoverageSummary",
                     "--max-threads", "2"]) == 0
    exp = os.path.join(wd, "output", "analysis_2d",
                       "experiment_reads.fq_ref.fa_LastParams")
    assert sam_records(os.path.join(exp, "mapping.sam"))
    for a in ("Substitutions", "KmerAnalysis"):
        assert os.path.exists(os.path.join(exp, "analysis_" + a, "DONE"))
    trace = json.load(open(tmp_path / "prof" / "pipeline_trace.json"))
    assert trace["traceEvents"]


def test_cli_run_raises_without_a_card(working_dir, tmp_path):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wd = copy_inputs(working_dir, tmp_path / "wd")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["run", wd, "--mappers", "LastParams"])
    assert not os.path.exists(os.path.join(wd, "output"))


@pytest.mark.parametrize("name", ["CoverageDepth", "MarginAlignMetaAnalysis",
                                  "CustomTrackAssemblyHub"])
def test_unported_meta_analysis_fails_before_any_task(
        name, working_dir, tmp_path, monkeypatch):  # noqa: F811
    """The name is kept from when the pipeline refused these three
    before any task; they are ported now, and the port's pipeline run
    with each writes the JAX pipeline's files (PDFs too, with
    ``SOURCE_DATE_EPOCH`` pinned)."""
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    kw = dict(mappers=["LastParamsChain"], analyses=["Substitutions"],
              meta_analyses=["CoverageSummary", name], max_workers=1)
    jout = jax_run_pipeline(copy_inputs(working_dir, tmp_path / "jax"),
                            JaxConfig(**kw))
    pout = run_pipeline(copy_inputs(working_dir, tmp_path / "port"),
                        PipelineConfig(device="cpu", **kw))
    files = tree(pout)
    assert files == tree(jout)
    meta = [f for f in files if f.startswith("metaAnalysis_" + name)]
    assert meta
    for rel in files:
        if rel == "pipeline_stats.json" or rel.endswith(".png"):
            continue
        got = open(os.path.join(pout, rel), "rb").read()
        assert got == open(os.path.join(jout, rel), "rb").read(), rel


@pytest.mark.parametrize("field,name", [("mappers", "NoSuchMapper"),
                                        ("analyses", "NoSuchAnalysis"),
                                        ("meta_analyses", "NoSuchMeta")])
def test_unknown_names_fail_before_any_task(field, name, working_dir,  # noqa: F811
                                            tmp_path):
    wd = copy_inputs(working_dir, tmp_path / "wd")
    kw = dict(mappers=["LastParams"], analyses=["Substitutions"],
              meta_analyses=[], device="cpu")
    kw[field] = kw[field] + [name]
    with pytest.raises(ValueError, match=name):
        run_pipeline(wd, PipelineConfig(**kw))
    assert not os.path.exists(os.path.join(wd, "output"))


def test_two_process_environment_names_a5(working_dir, tmp_path,  # noqa: F811
                                          monkeypatch):
    """The name is kept from when a two-process environment raised
    (ROADMAP A5).  It is ported: the pipeline joins a gloo process group
    from the three variables, with a finite timeout, before any task (the
    joining is stopped here; two real ranks run in
    tests/test_torch_multihost.py)."""
    import torch.distributed

    wd = copy_inputs(working_dir, tmp_path / "wd")
    monkeypatch.setenv("NANOPORE_TPU_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("NANOPORE_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("NANOPORE_TPU_PROCESS_ID", "1")
    calls = []

    class Joined(Exception):
        pass

    def init_process_group(backend, **kwargs):
        calls.append((backend, kwargs))
        raise Joined()

    monkeypatch.setattr(torch.distributed, "init_process_group",
                        init_process_group)
    with pytest.raises(Joined):
        run_pipeline(wd, PipelineConfig(
            mappers=["LastParams"], analyses=["Substitutions"],
            meta_analyses=[], device="cpu"))
    (backend, kwargs), = calls
    assert backend == "gloo"
    assert kwargs["init_method"] == "tcp://localhost:1234"
    assert (kwargs["world_size"], kwargs["rank"]) == (2, 1)
    assert 0 < kwargs["timeout"].total_seconds() < float("inf")
    assert not os.listdir(os.path.join(wd, "output"))
