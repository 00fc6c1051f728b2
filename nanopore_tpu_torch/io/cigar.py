"""Exonerate-style cigar codec.

A copy of the JAX package's ``io/cigar.py``.

The reference exchanges alignments with cactus_realign as exonerate cigar
lines (utils.py:getExonerateCigarFormatString:168-180, cigarRead/
cigarReadFromString from bioio).  Our realigner is in-process, but we keep
the codec for parity testing and for the script-level shims.

Line format (as emitted at utils.py:175-177):

    cigar: <qname> <qstart> <qend> <qstrand> <tname> <tstart> <tend>
           <tstrand> <score> [<OP> <LEN>]...

with OP in {M, I, D}: M consumes both, I consumes the query, D consumes the
target.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from nanopore_tpu_torch.io.sam import SamRecord, CIG

_OP_TO_CHAR = {CIG.M: "M", CIG.I: "I", CIG.D: "D"}
_CHAR_TO_OP = {"M": CIG.M, "I": CIG.I, "D": CIG.D}


@dataclass
class ExonerateCigar:
    qname: str
    qstart: int
    qend: int
    qstrand: str  # '+' or '-'
    tname: str
    tstart: int
    tend: int
    tstrand: str
    score: float
    ops: list[tuple[int, int]] = field(default_factory=list)  # (CIG op, len)

    def to_line(self) -> str:
        op_str = " ".join(
            "%s %d" % (_OP_TO_CHAR[op], length) for op, length in self.ops
        )
        score = self.score
        score_str = str(int(score)) if float(score).is_integer() else repr(score)
        return "cigar: %s %d %d %s %s %d %d %s %s %s" % (
            self.qname, self.qstart, self.qend, self.qstrand,
            self.tname, self.tstart, self.tend, self.tstrand,
            score_str, op_str,
        )

    @property
    def match_length(self) -> int:
        return sum(l for op, l in self.ops if op == CIG.M)


def parse_exonerate_cigar(line: str) -> ExonerateCigar:
    fields = line.strip().split()
    assert fields[0] == "cigar:", "not an exonerate cigar line: %r" % line
    ops = []
    rest = fields[10:]
    assert len(rest) % 2 == 0
    for i in range(0, len(rest), 2):
        ops.append((_CHAR_TO_OP[rest[i]], int(rest[i + 1])))
    return ExonerateCigar(
        qname=fields[1],
        qstart=int(fields[2]),
        qend=int(fields[3]),
        qstrand=fields[4],
        tname=fields[5],
        tstart=int(fields[6]),
        tend=int(fields[7]),
        tstrand=fields[8],
        score=float(fields[9]),
        ops=ops,
    )


def exonerate_cigar_string(rec: SamRecord) -> str:
    """Exonerate cigar for a SAM record, in query (soft-clip-free) coords.

    Semantics of utils.py:getExonerateCigarFormatString:168-180: query
    coordinates run 0..(qend-qstart) on '+', target coordinates are the SAM
    pos..aend, score is 1, and only M/I/D ops are emitted (soft/hard clips
    dropped).
    """
    for op, _ in rec.cigar:
        assert op in (CIG.M, CIG.I, CIG.D, CIG.S, CIG.H), (
            "unsupported cigar op %d" % op
        )
    ops = [(op, l) for op, l in rec.cigar if op in (CIG.M, CIG.I, CIG.D)]
    ec = ExonerateCigar(
        qname=rec.qname,
        qstart=0,
        qend=rec.qend - rec.qstart,
        qstrand="+",
        tname=rec.rname,
        tstart=rec.pos,
        tend=rec.aend,
        tstrand="+",
        score=1,
        ops=ops,
    )
    return ec.to_line()
