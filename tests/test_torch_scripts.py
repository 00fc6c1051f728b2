"""The port's scripts against the JAX package's, on the CPU.

Each script of ``nanopore_tpu_torch/scripts/`` runs on the same seeded
inputs as its JAX twin and must write the same bytes, mirroring
tests/test_scripts.py:

* ``pull_averages``, ``extract_coverage_xmls``, ``variant_table``,
  ``blast_tex`` (through ``textable``): text files equal;
* ``blast_unmapped``: its reports equal without BLAST (every read a
  no-hit), and with a stand-in ``blastn`` on ``PATH`` that answers in
  outfmt 7; ``parse_blast`` on the reference's format;
* ``mappability_plots``, ``scatter_plots``: the flowcell layout equal,
  and the PDFs byte for byte with ``SOURCE_DATE_EPOCH`` pinned (the
  scripts draw only where matplotlib is present; these tests skip
  without it);
* ``rescue_2d`` with ``device="cpu"``: both TSVs equal to the JAX
  script's (run on the CPU as its own code runs there: XLA scans) on a
  6 kb reference with six reads of 260-400 bases mapped by the JAX
  engine; a row may differ only where the Pallas kernel in interpret
  mode decodes the port's cigar for that job (the MEA tie rule of
  tests/test_torch_chain_realign.py).  Its rows do not depend on the
  batch size (4, the CPU default and the JAX script's, against 512, the
  card's).  On the card a width above 512 is refused before any work
  (ROADMAP C10, C11), and the default device raises without a card.
"""

import os
import shutil
import stat
import sys

import numpy as np
import pytest
import torch

import nanopore_tpu.ops.pairhmm_pallas_realign as ppr
from nanopore_tpu.io.seqio import read_fasta_dict, read_fastq_dict
from nanopore_tpu.mapping.engine import MappingEngine as JaxEngine
from nanopore_tpu.mapping.presets import MAPPER_REGISTRY as JAX_PRESETS
from nanopore_tpu.ops.mea import mea_traceback_fwd
from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.io.sam import CIG as JaxCIG
from nanopore_tpu.io.sam import SamReader as JaxSamReader
from nanopore_tpu.io.sam import SamRecord as JaxSamRecord
from nanopore_tpu.io.sam import SamWriter as JaxSamWriter
from nanopore_tpu.scripts import blast_tex as jax_blast_tex
from nanopore_tpu.scripts import blast_unmapped as jax_blast_unmapped
from nanopore_tpu.scripts import extract_coverage_xmls as jax_extract
from nanopore_tpu.scripts import pull_averages as jax_pull
from nanopore_tpu.scripts import rescue_2d as jax_rescue
from nanopore_tpu.scripts import variant_table as jax_variant
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.analyses.plots import HAVE_MPL
from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
from nanopore_tpu_torch.ops.realign import untile
from nanopore_tpu_torch.scripts import (
    blast_tex,
    blast_unmapped,
    extract_coverage_xmls,
    pull_averages,
    rescue_2d,
    variant_table,
)
from test_scripts import write_coverage_xml
from test_torch_chain_realign import write_small_inputs

needs_mpl = pytest.mark.skipif(not HAVE_MPL, reason="matplotlib missing")


def same_files(a, b) -> list:
    """The files under two directories (relative paths), every file's
    bytes equal."""
    def tree(root):
        return sorted(os.path.relpath(os.path.join(r, f), root)
                      for r, _, files in os.walk(root) for f in files)

    names = tree(a)
    assert names == tree(b)
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    return names


def both(tmp_path, run):
    """``run(module_pair_index, outdir)`` for the port (0) and the JAX
    package (1) into sibling directories; returns their file names."""
    dirs = []
    for i, name in enumerate(("port", "jax")):
        d = tmp_path / name
        os.makedirs(d)
        run(i, d)
        dirs.append(d)
    return same_files(*dirs)


# ---- XML summaries --------------------------------------------------------- #

@pytest.mark.parametrize("mappers", [
    ("LastParamsChain", "BwaParamsRealignEm", "Blasr"),
    ("LastParamsRealign",),  # Realign without Em: header only
])
def test_pull_averages_equal(tmp_path, mappers):
    rng = np.random.default_rng(len(mappers))
    paths = []
    for mapper in mappers:
        for rep in range(3):
            d = tmp_path / ("rep%d" % rep) / ("x.fa_" + mapper)
            os.makedirs(d)
            p = str(d / "coverage_bestPerRead.xml")
            write_coverage_xml(p, mapper, avg=float(rng.uniform(0.6, 0.95)))
            paths.append(p)
    lst = str(tmp_path / "list.txt")
    open(lst, "w").write("\n".join(paths) + "\n")
    names = both(tmp_path, lambda i, d: (pull_averages, jax_pull)[i].main(
        [lst, str(d / "out.tsv")]))
    assert names == ["out.tsv"]
    lines = open(tmp_path / "port" / "out.tsv").read().strip().split("\n")
    assert lines[0].startswith("mapper\t")
    assert len(lines) == (1 + 3 if len(mappers) == 3 else 1)


def test_extract_coverage_xmls_equal(tmp_path):
    paths = []
    for i in range(3):
        p = str(tmp_path / ("c%d.xml" % i))
        write_coverage_xml(p, "M", avg=0.7 + 0.05 * i)
        paths.append(p)
    both(tmp_path, lambda i, d: (extract_coverage_xmls, jax_extract)[i].main(
        paths + [str(d / "out.txt")]))
    lines = open(tmp_path / "port" / "out.txt").read().strip().split("\n")
    assert lines[0].startswith("length ") and len(lines[0].split()) == 7


# ---- LaTeX tables ---------------------------------------------------------- #

def test_variant_table_equal(tmp_path):
    rng = np.random.default_rng(4)
    squares = str(tmp_path / "squares.txt")
    cov = ["30", "60", "ALL"]
    header = ["readType", "mapper", "caller", "%heldOut"]
    for metric in ("recall", "precision", "fscore"):
        for c in cov:
            header += ["%s_%s_coverage_%s" % (k, metric, c)
                       for k in ("min", "avg", "max")]
    with open(squares, "w") as fh:
        fh.write("\t".join(header) + "\n")
        for mapper in ("LastParamsChain", "Bwa_Params"):
            row = ["2d", mapper, "marginAlignMaxExpectedSnpCalls_cactus",
                   "0.05"] + [repr(float(v)) for v in rng.random(27)]
            fh.write("\t".join(row) + "\n")
        fh.write("too\tshort\n")
    both(tmp_path, lambda i, d: (variant_table, jax_variant)[i].main(
        [str(d / "table.tex"), squares]))
    text = open(tmp_path / "port" / "table.tex").read()
    assert "sidewaystable" in text and text.count("\\begin{tabular}") == 2


# ---- BLAST of the unmapped reads ------------------------------------------- #

def blast_working_dir(tmp_path):
    """output/processedReadFastqFiles/<readType>/ with seeded reads, and
    two of the four RealignEm experiments mapping a few of them."""
    rng = np.random.default_rng(5)
    wd = tmp_path / "wd"
    os.makedirs(wd / "referenceFastaFiles")
    (wd / "referenceFastaFiles" / "ref.fa").write_text(">ref\nACGT\n")
    for read_type in ("2D", "template"):
        fq_dir = wd / "output" / "processedReadFastqFiles" / read_type
        os.makedirs(fq_dir)
        names = ["%s_r%d" % (read_type, i) for i in range(12)]
        with open(fq_dir / "reads.fq", "w") as fh:
            for n in names:
                seq = "".join(rng.choice(list("ACGT"), 30))
                fh.write("@%s\n%s\n+\n%s\n" % (n, seq, "I" * 30))
        for mapper in ("LastParamsRealignEm", "BwaParamsRealignEm"):
            exp = (wd / "output" / ("analysis_" + read_type)
                   / ("experiment_reads.fq_ref.fa_" + mapper))
            os.makedirs(exp)
            with JaxSamWriter(str(exp / "mapping.sam"), {"ref": 4}) as w:
                for n in rng.choice(names, 4, replace=False):
                    w.write(mapped_record(n))
    return str(wd)


def mapped_record(name):
    return JaxSamRecord(qname=str(name), flag=0, rname="ref", pos=0, mapq=9,
                     cigar=[(JaxCIG.M, 4)], seq="ACGT")


FAKE_BLASTN = """#!%s
import sys
names = [l[1:].strip() for l in sys.stdin if l.startswith(">")]
for i, n in enumerate(names):
    print("# BLASTN 2.2\\n# Query: %%s" %% n)
    if i %% 3 == 2:
        print("# 0 hits found")
        continue
    print("# %%d hits found" %% (1 + i %% 2))
    sp = ("Escherichia_coli", "Phage lambda")[i %% 2]
    for k in range(1 + i %% 2):
        print("%%s\\tgi|%%d|\\t%%s\\t%%s genome" %% (n, k, sp, sp))
"""


@pytest.mark.parametrize("with_blast", [False, True])
def test_blast_unmapped_and_blast_tex_equal(tmp_path, monkeypatch,
                                            with_blast):
    """Without ``blastn`` every unmapped read is a no-hit; with a
    stand-in on ``PATH`` both scripts pipe the same queries to it and
    write the same reports, and ``blast_tex`` the same document."""
    wd = blast_working_dir(tmp_path)
    bindir = tmp_path / "bin"
    os.makedirs(bindir)
    if with_blast:
        exe = bindir / "blastn"
        exe.write_text(FAKE_BLASTN % sys.executable)
        exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(bindir))
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")  # the bar plots
    assert (shutil.which("blastn") is not None) == with_blast

    def run(i, d):
        (blast_unmapped, jax_blast_unmapped)[i].main(
            ["--working-dir", wd, "--output-dir", str(d / "blast")])
        (blast_tex, jax_blast_tex)[i].main(
            [str(d / "blast"), str(d / "blast.tex")])

    names = both(tmp_path, run)
    assert "blast/2D_blast_report.txt" in names
    assert "blast/template_no_hits.fasta" in names
    report = open(tmp_path / "port" / "blast" / "2D_blast_report.txt").read()
    assert ("Escherichia_coli" in report) == with_blast
    tex = open(tmp_path / "port" / "blast.tex").read()
    assert tex.endswith("\\end{document}\n")
    assert ("Escherichia\\_coli" in tex) == with_blast


def test_parse_blast_equal():
    text = (
        "# BLASTN 2.2\n# Query: read1\n# 2 hits found\n"
        "read1\tgi|1|\tEscherichia coli\tE. coli genome\n"
        "read1\tgi|2|\tE. fergusonii\tgenome\n"
        "# BLASTN 2.2\n# Query: read2\n# 0 hits found\n"
    )
    got = list(blast_unmapped.parse_blast(text.splitlines(True)))
    assert got == list(jax_blast_unmapped.parse_blast(text.splitlines(True)))
    assert got[0] == ("read1", ["gi|1|", "Escherichia coli",
                                "E. coli genome"])
    assert got[1] == ("read2", None)


# ---- figures --------------------------------------------------------------- #

def test_flowcell_layout_equal():
    from nanopore_tpu.scripts.mappability_plots import (
        flowcell_layout as jax_layout,
    )
    from nanopore_tpu_torch.scripts.mappability_plots import flowcell_layout

    lay = flowcell_layout()
    np.testing.assert_array_equal(lay, jax_layout())
    assert sorted(lay.flatten().tolist()) == list(range(1, 513))


@needs_mpl
def test_mappability_pdf_equal(tmp_path, monkeypatch):
    from nanopore_tpu.scripts import mappability_plots as jax_mp
    from nanopore_tpu_torch.scripts import mappability_plots as mp

    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    rng = np.random.default_rng(0)
    args = []
    for i in range(2):
        p = tmp_path / ("chan%d.tsv" % i)
        with open(p, "w") as fh:
            fh.write("Channel\tReadCount\tMappableReadCount\n")
            for ch in range(1, 513):
                t = int(rng.integers(0, 20))
                fh.write("%d\t%d\t%d\n" % (ch, t, rng.integers(0, t + 1)))
        args.append("run%d=%s" % (i, p))
    both(tmp_path, lambda i, d: (mp, jax_mp)[i].main(
        [str(d / "mapp.pdf")] + args))
    assert os.path.getsize(tmp_path / "port" / "mapp.pdf") > 1000


@needs_mpl
@pytest.mark.parametrize("mode", ["summary", "combined", "combined-flat"])
def test_scatter_pdf_equal(tmp_path, monkeypatch, mode):
    from nanopore_tpu.scripts import scatter_plots as jax_sp
    from nanopore_tpu_torch.scripts import scatter_plots as sp

    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    rng = np.random.default_rng(1)
    p = tmp_path / "in.txt"
    if mode == "summary":
        with open(p, "w") as fh:
            fh.write("AvgInsert\tAvgDelete\tavgMismatch\n")
            for i in range(6):
                fh.write("exp%d\t%.3f\t%.3f\t%.3f\n"
                         % (i, 0.01 * i, 0.02 * i, 0.03 + 0.001 * i))
    else:
        n = 200
        length = rng.integers(500, 20000, n).astype(float)
        ident = np.clip(0.9 - length / 1e5 + rng.normal(0, 0.02, n), 0, 1)
        with open(p, "w") as fh:
            for name, vals in [
                ("length", length),
                ("identity", ident),
                ("mismatches", rng.uniform(0, 0.1, n)),
                ("insertions", rng.uniform(0, 0.05, n)),
                ("deletions", rng.uniform(0, 0.08, n)),
            ]:
                fh.write(name + " " + " ".join("%.5f" % v for v in vals)
                         + "\n")
    extra = ["--no-trends"] if mode == "combined-flat" else []
    kind = mode.split("-")[0]
    both(tmp_path, lambda i, d: (sp, jax_sp)[i].main(
        [kind, str(p), str(d / "out.pdf")] + extra))
    assert os.path.getsize(tmp_path / "port" / "out.pdf") > 500


# ---- rescue_2d ------------------------------------------------------------- #

def pallas_pair_cigar(window, seq, band_width):
    """The cigar the Pallas realign kernel (interpret mode) and the MEA
    walk decode for one rescue job, under the default model."""
    old = ppr.CHUNK, ppr.SEG
    ppr.CHUNK, ppr.SEG = 8, 4
    try:
        x, y, guide = rescue_2d.guide_pair(seq, window)
        batch = prepare_banded_batch([(x, y, guide)], band_width=band_width)
        out = ppr.PallasRealignPlan(
            batch, jax_params(JaxModel.default()), 0.5, 0.0, emit_em=False,
        ).run(interpret=True)
        band = untile(out["dirs_raw"], 1)[0]
        return list(mea_traceback_fwd(band, np.asarray(batch.offsets)[0],
                                      len(y), len(x)))
    finally:
        ppr.CHUNK, ppr.SEG = old
        ppr._pallas_realign_call.clear_cache()


@pytest.fixture(scope="module")
def rescue_dir(tmp_path_factory):
    """A working directory in the reference layout: the same six reads
    as template and complement, the 2D SAM a JAX-engine ``LastParams``
    mapping of them, the template SAM mapping one read (left out of
    the rescue), the complement SAM header-only."""
    d = tmp_path_factory.mktemp("rescue")
    fa, fq = write_small_inputs(d, 3, n_reads=6)
    os.makedirs(d / "referenceFastaFiles")
    shutil.copy(fa, d / "referenceFastaFiles" / "ref.fa")
    for read_type in ("template", "complement"):
        os.makedirs(d / "readFastqFiles" / read_type)
        shutil.copy(fq, d / "readFastqFiles" / read_type / "reads.fq")
    twod = str(d / "twod.sam")
    JaxEngine(read_fasta_dict(fa), JAX_PRESETS["LastParams"].config
              ).map_fastq(fq, twod)
    reader = JaxSamReader(twod)
    first = next(iter(reader.mapped()))
    for read_type, recs in (("template", [first]), ("complement", [])):
        with JaxSamWriter(str(d / (read_type + ".sam")),
                          template=reader) as w:
            for r in recs:
                w.write(r)
    sams = [str(d / (t + ".sam")) for t in ("template", "complement")]
    jax_rescue.main(sams + [twod, "--working-dir", str(d),
                            "--output-dir", str(d / "jax")])
    rescue_2d.main(sams + [twod, "--working-dir", str(d),
                           "--output-dir", str(d / "port"),
                           "--device", "cpu"])
    return {"dir": d, "sams": sams + [twod], "left_out": first.qname,
            "mapped": {r.qname for r in reader.mapped()}}


def rows(path):
    return open(path).read().splitlines()


def test_rescue_2d_matches_jax_on_the_cpu(rescue_dir):
    d = rescue_dir["dir"]
    assert sorted(os.listdir(d / "port")) == sorted(os.listdir(d / "jax"))
    ref = read_fasta_dict(str(d / "referenceFastaFiles" / "ref.fa"))
    seqs = read_fastq_dict(str(d / "readFastqFiles" / "template"
                               / "reads.fq"))
    twod = {r.qname: r for r in JaxSamReader(rescue_dir["sams"][2])
            if not r.is_unmapped}

    def pallas_row(name):
        """The metrics of the Pallas kernel's decode of ``name``'s job."""
        rec = twod[name]
        window = ref[rec.rname][rec.pos:rec.aend]
        x, y, _ = rescue_2d.guide_pair(seqs[name], window)
        cigar = pallas_pair_cigar(window, seqs[name], 64)
        return [str(v) for v in rescue_2d.alignment_metrics(cigar, y, x)]

    ties = 0
    for read_type in ("template", "complement"):
        got = rows(d / "port" / (read_type + "_metrics.tsv"))
        want = rows(d / "jax" / (read_type + "_metrics.tsv"))
        assert got[0] == want[0] == rescue_2d.HEADER.rstrip("\n")
        assert len(got) == len(want) == len(rescue_dir["mapped"])
        assert rescue_dir["left_out"] not in {r.split("\t")[0]
                                              for r in got[1:]}
        for g, w in zip(got[1:], want[1:]):
            if g == w:
                continue
            ties += 1
            assert w.split("\t")[:2] == g.split("\t")[:2]
            assert g.split("\t")[2:] == pallas_row(g.split("\t")[0])
    assert ties <= 2, ties
    # the tie rule's helper decodes the port's row where there is no tie
    first = rows(d / "port" / "template_metrics.tsv")[1].split("\t")
    assert first[2:] == pallas_row(first[0])


def test_rescue_2d_rows_do_not_depend_on_the_batch_size(rescue_dir):
    """``rescue_metrics`` on every template job in batches of 4 (the
    script's on the CPU) and of 512 (its batch on the card): the rows
    the script wrote, in its order."""
    d = rescue_dir["dir"]
    ref = read_fasta_dict(str(d / "referenceFastaFiles" / "ref.fa"))
    seqs = read_fastq_dict(str(d / "readFastqFiles" / "template"
                               / "reads.fq"))
    twod = {r.qname: r for r in JaxSamReader(rescue_dir["sams"][2])
            if not r.is_unmapped}
    jobs = [(n, twod[n].rname, seqs[n],
             ref[twod[n].rname][twod[n].pos:twod[n].aend])
            for n in seqs if n in twod and n != rescue_dir["left_out"]]
    want = open(d / "port" / "template_metrics.tsv").readlines()[1:]
    params = make_kernel_params(PairHmmModel.default())
    for batch_size in (4, 512):
        assert rescue_2d.rescue_metrics(jobs, params, 64, batch_size,
                                        "cpu") == want


@pytest.mark.parametrize("device", [None, "cuda", "meta"])
def test_rescue_2d_refuses_an_unserved_width_off_the_cpu(rescue_dir,
                                                         tmp_path, device):
    t, c, twod = rescue_dir["sams"]
    with pytest.raises(ValueError, match="C10"):
        rescue_2d.rescue(t, c, twod, str(rescue_dir["dir"]),
                         str(tmp_path / "out"), band_width=2049, device=device)
    assert not os.path.exists(tmp_path / "out")


def test_rescue_2d_default_device_raises_without_a_card(rescue_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    t, c, twod = rescue_dir["sams"]
    with pytest.raises(RuntimeError, match="CUDA"):
        rescue_2d.main([t, c, twod, "--working-dir", str(rescue_dir["dir"]),
                        "--output-dir", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")
