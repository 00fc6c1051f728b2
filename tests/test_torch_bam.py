"""The port's host BAM, BGZF, BAI, exonerate-cigar and 2bit I/O against
the JAX package's.

Both packages write with the standard library's ``zlib`` and ``struct``,
so every file is held byte for byte against the JAX package's on the
same records (seeded with numpy), mirroring tests/test_bam.py (BGZF
conformance, virtual offsets, the EOF marker, the record codec,
``reg2bin``, the sorted BAM and its ``.bai``, linear windows that span,
the header text), tests/test_io.py::TestExonerateCigar and the 2bit
round trip of tests/test_pipeline.py.  ``sam2bam`` and ``bam2sam``
through ``nanopore_tpu_torch.cli.main`` write the files that
``nanopore_tpu.cli.main`` writes, at the default output names too.
"""

import gzip
import os
import struct

import numpy as np
import pytest

from nanopore_tpu.cli import main as jax_cli_main
from nanopore_tpu.io import bam as jax_bam
from nanopore_tpu.io import cigar as jax_cigar
from nanopore_tpu.io import sam as jax_sam
from nanopore_tpu.io import twobit as jax_twobit
from nanopore_tpu_torch import cli
from nanopore_tpu_torch.io import bam, cigar, sam, twobit
from nanopore_tpu_torch.io import (
    ExonerateCigar,
    exonerate_cigar_string,
    parse_exonerate_cigar,
)

EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b0003"
                          "000000000000000000")


def record(pkg_sam, qname="r1", pos=10, **kw):
    """tests/test_bam.py's record, built with ``pkg_sam``'s types."""
    fields = dict(
        qname=qname, flag=0, rname="chr1", pos=pos, mapq=30,
        cigar=pkg_sam.parse_cigar("2S3M1I2M2D1M3S"),
        seq="TTACGGACAGAAA", qual="IIIIIIIIIIIII",
        tags=[("AS", "i", 42), ("XN", "Z", "hello"), ("XF", "f", 0.5)],
    )
    fields.update(kw)
    return pkg_sam.SamRecord(**fields)


def seeded_records(pkg_sam, seed, n=60, ref_len=200_000):
    """Random records on two contigs: both strands, secondaries,
    unmapped ones, every tag type the codec writes, odd and even
    lengths, ``*`` qualities."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if rng.random() < 0.1:
            out.append(pkg_sam.SamRecord(
                qname="u%d" % i, seq="".join(rng.choice(list("ACGTN"), 7)),
                qual="*"))
            continue
        ops, qlen = [], 0
        if rng.random() < 0.5:
            ops.append((pkg_sam.CIG.S, int(rng.integers(1, 20))))
        for _ in range(int(rng.integers(1, 6))):
            op = int(rng.choice([pkg_sam.CIG.M, pkg_sam.CIG.I,
                                 pkg_sam.CIG.D]))
            ops.append((op, int(rng.integers(1, 400))))
        ops.insert(1 if ops[0][0] == pkg_sam.CIG.S else 0,
                   (pkg_sam.CIG.M, int(rng.integers(1, 9000))))
        qlen = sum(l for op, l in ops if op in (pkg_sam.CIG.M, pkg_sam.CIG.I,
                                                pkg_sam.CIG.S))
        seq = "".join(rng.choice(list("ACGT"), qlen))
        qual = ("*" if rng.random() < 0.3 else "".join(
            chr(33 + int(q)) for q in rng.integers(0, 41, qlen)))
        flag = int(rng.choice([0, 16, 256, 272]))
        out.append(pkg_sam.SamRecord(
            qname="q%d" % i, flag=flag,
            rname=("chr1", "chr2")[int(rng.integers(0, 2))],
            pos=int(rng.integers(0, ref_len - 20_000)),
            mapq=int(rng.integers(0, 61)), cigar=ops, seq=seq, qual=qual,
            tags=[("NM", "i", int(rng.integers(-70_000, 70_000))),
                  ("AS", "i", int(rng.integers(-200, 200))),
                  ("XS", "i", int(rng.integers(-30_000, 30_000))),
                  ("XF", "f", float(rng.random())),
                  ("XA", "A", "ACGT"[int(rng.integers(0, 4))]),
                  ("XN", "Z", "z%d" % i)]))
    return out


def write_sam(pkg_sam, path, records, refs):
    with pkg_sam.SamWriter(str(path), refs) as w:
        for r in records:
            w.write(r)
    return str(path)


def read_bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


# ---- BGZF ---------------------------------------------------------------- #

@pytest.mark.parametrize("seed", [0, 1])
def test_bgzf_writer_bytes_equal_and_gzip_conformant(tmp_path, seed):
    payload = np.random.default_rng(seed).integers(
        0, 256, 200_000, dtype=np.uint8).tobytes()
    paths = []
    for name, mod in (("p", bam), ("j", jax_bam)):
        p = str(tmp_path / ("%s.bgzf" % name))
        with mod.BgzfWriter(p) as w:
            w.write(payload[:70_000])
            w.write(payload[70_000:])
        paths.append(p)
    blob = read_bytes(paths[0])
    assert blob == read_bytes(paths[1])
    assert gzip.decompress(blob) == payload
    assert blob.endswith(EOF_BLOCK)


def test_bgzf_reader_reads_the_jax_writer_and_back(tmp_path):
    payload = np.random.default_rng(2).integers(
        0, 256, 150_000, dtype=np.uint8).tobytes()
    for writer, reader in ((jax_bam, bam), (bam, jax_bam)):
        p = str(tmp_path / "x.bgzf")
        with writer.BgzfWriter(p) as w:
            w.write(payload)
        r = reader.BgzfReader(p)
        assert r.read(len(payload) + 10) == payload
        r.close()


def test_bgzf_virtual_offsets_equal_and_seekable(tmp_path):
    chunks = [b"a" * 40_000, b"b" * 40_000, b"c" * 123, b"d" * 70_000]
    offsets = {}
    for name, mod in (("p", bam), ("j", jax_bam)):
        p = str(tmp_path / ("%s.bgzf" % name))
        w = mod.BgzfWriter(p)
        offsets[name] = []
        for c in chunks:
            offsets[name].append(w.tell_virtual())
            w.write(c)
        w.close()
    assert offsets["p"] == offsets["j"]
    r = bam.BgzfReader(str(tmp_path / "j.bgzf"))
    for off, c in reversed(list(zip(offsets["p"], chunks))):
        r.seek_virtual(off)
        assert r.read(len(c)) == c
    r.close()


def test_bgzf_eof_marker(tmp_path):
    p = str(tmp_path / "x.bgzf")
    with bam.BgzfWriter(p) as w:
        w.write(b"data")
    assert read_bytes(p).endswith(EOF_BLOCK)


# ---- the record codec ------------------------------------------------------ #

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_record_codec_bytes_equal(seed):
    ref_ids = {"chr1": 0, "chr2": 1}
    mine = seeded_records(sam, seed)
    theirs = seeded_records(jax_sam, seed)
    for p, j in zip(mine, theirs):
        body = bam.encode_bam_record(p, ref_ids)
        assert body == jax_bam.encode_bam_record(j, ref_ids)
        got = bam.decode_bam_record(body, ["chr1", "chr2"])
        want = jax_bam.decode_bam_record(body, ["chr1", "chr2"])
        assert got.to_line() == want.to_line()
        assert (got.qname, got.flag, got.rname, got.pos, got.cigar,
                got.seq, got.qual) == (p.qname, p.flag, p.rname, p.pos,
                                       p.cigar, p.seq, p.qual)


def test_record_roundtrip_as_in_test_bam():
    rec = record(sam)
    body = bam.encode_bam_record(rec, {"chr1": 0})
    assert body == jax_bam.encode_bam_record(record(jax_sam), {"chr1": 0})
    got = bam.decode_bam_record(body, ["chr1"])
    assert (got.qname, got.flag, got.rname, got.pos, got.mapq, got.cigar,
            got.seq, got.qual) == (rec.qname, rec.flag, "chr1", rec.pos,
                                   rec.mapq, rec.cigar, rec.seq, rec.qual)
    assert got.tags[:2] == rec.tags[:2]
    assert got.tags[2][0] == "XF" and abs(got.tags[2][2] - 0.5) < 1e-7


def test_unmapped_record_and_missing_qual():
    rec = sam.SamRecord(qname="u1", seq="ACGT", qual="*")
    body = bam.encode_bam_record(rec, {})
    assert body == jax_bam.encode_bam_record(
        jax_sam.SamRecord(qname="u1", seq="ACGT", qual="*"), {})
    got = bam.decode_bam_record(body, [])
    assert got.is_unmapped and got.rname == "*"
    assert got.seq == "ACGT" and got.qual == "*"


def test_reg2bin():
    assert bam.reg2bin(0, 1) == 4681
    assert bam.reg2bin(0, 1 << 14) == 4681
    assert bam.reg2bin(0, (1 << 14) + 1) == 585
    assert bam.reg2bin(0, 1 << 29) == 0
    rng = np.random.default_rng(3)
    beg = rng.integers(0, 1 << 29, 2000)
    span = 10 ** rng.uniform(0, 8.5, 2000)
    end = np.minimum(beg + 1 + span.astype(np.int64), 1 << 29)
    for b, e in zip(beg.tolist(), end.tolist()):
        assert bam.reg2bin(b, e) == jax_bam.reg2bin(b, e)


# ---- BAM files and their index -------------------------------------------- #

def test_bam_file_bytes_equal_and_roundtrip(tmp_path):
    refs = {"chr1": 200_000, "chr2": 200_000}
    for name, mod, pkg_sam in (("p", bam, sam), ("j", jax_bam, jax_sam)):
        with mod.BamWriter(str(tmp_path / ("%s.bam" % name)), refs) as w:
            for r in seeded_records(pkg_sam, 4):
                w.write(r)
    assert read_bytes(tmp_path / "p.bam") == read_bytes(tmp_path / "j.bam")
    with bam.BamReader(str(tmp_path / "j.bam")) as br:
        assert br.references == ["chr1", "chr2"]
        assert br.reference_lengths == refs
        got = [r.to_line() for r in br]
    assert got == [r.to_line()
                   for r in jax_bam.bam_records(str(tmp_path / "j.bam"))]


@pytest.mark.parametrize("seed", [5, 6])
def test_sorted_bam_and_index_bytes_equal(tmp_path, seed):
    refs = {"chr1": 200_000, "chr2": 200_000}
    for name, mod, pkg_sam in (("p", bam, sam), ("j", jax_bam, jax_sam)):
        src = write_sam(pkg_sam, tmp_path / ("%s.sam" % name),
                        seeded_records(pkg_sam, seed, n=120), refs)
        mod.sam_to_sorted_bam(src, str(tmp_path / ("%s.bam" % name)))
    for ext in (".bam", ".bam.bai"):
        assert read_bytes(tmp_path / ("p" + ext)) == read_bytes(
            tmp_path / ("j" + ext)), ext
    got = bam.bam_records(str(tmp_path / "p.bam"))
    mapped = [g for g in got if not g.is_unmapped]
    keys = [({"chr1": 0, "chr2": 1}[g.rname], g.pos) for g in mapped]
    assert keys == sorted(keys)
    blob = read_bytes(tmp_path / "p.bam.bai")
    assert blob[:4] == b"BAI\x01"
    assert struct.unpack("<i", blob[4:8])[0] == 2


def test_bai_linear_windows_spanning(tmp_path):
    for name, mod, pkg_sam in (("p", bam, sam), ("j", jax_bam, jax_sam)):
        p = str(tmp_path / ("%s.bam" % name))
        with mod.BamWriter(p, {"chr1": 1 << 20}) as w:
            w.write(record(pkg_sam, "far", pos=100_000))
            w.write(record(pkg_sam, "long", pos=200_000,
                           cigar=[(pkg_sam.CIG.M, 13),
                                  (pkg_sam.CIG.D, 40_000)]))
            w.write_index(p + ".bai")
    blob = read_bytes(tmp_path / "p.bam.bai")
    assert blob == read_bytes(tmp_path / "j.bam.bai")
    # two bins of one chunk each, then the linear index: the second
    # record spans windows 200000 >> 14 = 12 to 240012 >> 14 = 14
    assert struct.unpack("<i", blob[8:12])[0] == 2
    assert struct.unpack("<i", blob[60:64])[0] == 15


def test_header_text_preserved(tmp_path):
    for name, mod, pkg_sam in (("p", bam, sam), ("j", jax_bam, jax_sam)):
        src = write_sam(pkg_sam, tmp_path / ("%s.sam" % name),
                        [record(pkg_sam)], {"chr1": 500})
        mod.sam_to_sorted_bam(src, str(tmp_path / ("%s.bam" % name)))
    assert read_bytes(tmp_path / "p.bam") == read_bytes(tmp_path / "j.bam")
    with bam.BamReader(str(tmp_path / "p.bam")) as br:
        assert "SO:coordinate" in br.header_text
        assert "SN:chr1" in br.header_text


# ---- sam2bam / bam2sam ----------------------------------------------------- #

@pytest.mark.parametrize("named", [True, False])
def test_sam2bam_bam2sam_write_the_jax_files(tmp_path, capsys, named):
    refs = {"chr1": 200_000, "chr2": 200_000}
    for name, pkg_sam in (("p", sam), ("j", jax_sam)):
        os.makedirs(tmp_path / name)
        write_sam(pkg_sam, tmp_path / name / "x.sam",
                  seeded_records(pkg_sam, 7, n=40), refs)
    for name, main in (("p", cli.main), ("j", jax_cli_main)):
        d = tmp_path / name
        out = ["-o", str(d / "y.bam")] if named else []
        assert main(["sam2bam", str(d / "x.sam")] + out) == 0
        bam_path = str(d / ("y.bam" if named else "x.bam"))
        out = ["-o", str(d / "back.sam")] if named else []
        assert main(["bam2sam", bam_path] + out) == 0
    p_files = sorted(os.listdir(tmp_path / "p"))
    assert p_files == sorted(os.listdir(tmp_path / "j"))
    # at the default names bam2sam writes the round trip over x.sam
    assert len(p_files) == (4 if named else 3)
    for f in p_files:
        assert read_bytes(tmp_path / "p" / f) == read_bytes(
            tmp_path / "j" / f), f
    back = tmp_path / "p" / ("back.sam" if named else "x.sam")
    got = sam.sam_records(str(back))
    assert len(got) == 40
    mapped = [r for r in got if not r.is_unmapped]
    assert [(r.rname, r.pos) for r in mapped] == sorted(
        (r.rname, r.pos) for r in mapped)


# ---- exonerate cigars ------------------------------------------------------ #

def test_exonerate_cigar_roundtrip_as_in_test_io():
    rec = sam.SamRecord(qname="r1", flag=0, rname="ref", pos=5,
                        cigar=sam.parse_cigar("2S3M1I2M"), seq="TTACGGAC")
    line = exonerate_cigar_string(rec)
    assert line == jax_cigar.exonerate_cigar_string(jax_sam.SamRecord(
        qname="r1", flag=0, rname="ref", pos=5,
        cigar=jax_sam.parse_cigar("2S3M1I2M"), seq="TTACGGAC"))
    ec = parse_exonerate_cigar(line)
    assert isinstance(ec, ExonerateCigar)
    assert ec.qname == "r1"
    assert (ec.qstart, ec.qend, ec.qstrand) == (0, 6, "+")
    assert (ec.tname, ec.tstart, ec.tend, ec.tstrand) == ("ref", 5, 10, "+")
    assert ec.ops == [(sam.CIG.M, 3), (sam.CIG.I, 1), (sam.CIG.M, 2)]
    assert ec.match_length == 5


@pytest.mark.parametrize("seed", [8, 9])
def test_exonerate_cigar_lines_equal(seed):
    mine = [r for r in seeded_records(sam, seed) if not r.is_unmapped]
    theirs = [r for r in seeded_records(jax_sam, seed)
              if not r.is_unmapped]
    for p, j in zip(mine, theirs):
        line = cigar.exonerate_cigar_string(p)
        assert line == jax_cigar.exonerate_cigar_string(j)
        got = cigar.parse_exonerate_cigar(line)
        want = jax_cigar.parse_exonerate_cigar(line)
        assert got.to_line() == want.to_line() == line
    ec = cigar.ExonerateCigar("q", 0, 9, "-", "t", 3, 12, "+", 2.5,
                              [(sam.CIG.M, 9)])
    assert ec.to_line() == jax_cigar.ExonerateCigar(
        "q", 0, 9, "-", "t", 3, 12, "+", 2.5,
        [(jax_sam.CIG.M, 9)]).to_line()


# ---- 2bit ------------------------------------------------------------------ #

def test_twobit_roundtrip_as_in_test_pipeline(tmp_path):
    p = str(tmp_path / "x.2bit")
    seqs = {"c1": "ACGTNNNACGT", "c2": "GGGG"}
    twobit.write_2bit(seqs, p)
    assert twobit.read_2bit_names(p) == {"c1": 11, "c2": 4}
    jax_twobit.write_2bit(seqs, str(tmp_path / "j.2bit"))
    assert read_bytes(p) == read_bytes(tmp_path / "j.2bit")


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_twobit_bytes_equal(tmp_path, seed):
    """N runs at either end and inside, lengths of every residue mod 4,
    lower case."""
    rng = np.random.default_rng(seed)
    seqs = {}
    for i in range(5):
        codes = rng.integers(0, 4, int(rng.integers(1, 3000)))
        seq = np.array(list("ACGT"))[codes]
        for _ in range(int(rng.integers(0, 4))):
            a = int(rng.integers(0, len(seq)))
            seq[a:a + int(rng.integers(1, 50))] = "N"
        if i == 0:
            seq[:3] = "N"
            seq[-2:] = "N"
        text = "".join(seq)
        seqs["contig_%d" % i] = text.lower() if i == 1 else text
    twobit.write_2bit(seqs, str(tmp_path / "p.2bit"))
    jax_twobit.write_2bit(seqs, str(tmp_path / "j.2bit"))
    assert read_bytes(tmp_path / "p.2bit") == read_bytes(tmp_path / "j.2bit")
    assert twobit.read_2bit_names(str(tmp_path / "p.2bit")) == {
        k: len(v) for k, v in seqs.items()}
