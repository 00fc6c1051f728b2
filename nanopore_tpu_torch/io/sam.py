"""A minimal, dependency-free SAM record model.

Replaces the pysam surface the reference leans on everywhere
(``aligned_pairs``, ``cigar``, ``qstart``/``qend``/``aend``, ``query``,
``Samfile`` read/write — e.g. reference nanopore/analyses/utils.py:1,
coverage.py:5).  Records are plain Python objects on the host; the compute
path converts them to padded int arrays (see nanopore_tpu_torch.ops.reductions).

Conventions (matching pysam 0.7.x as consumed by the reference):
- ``pos`` is 0-based.
- ``aligned_pairs`` yields (readPos, refPos) with readPos relative to
  ``query`` (the seq minus soft clipping), None on the non-consuming side of
  an indel, soft/hard clips excluded.
- ``query`` is ``seq`` with soft-clipped ends removed.
"""

from __future__ import annotations

import re

import numpy as np
from dataclasses import dataclass, field
from typing import Iterator, Optional


class CIG:
    """Cigar op codes (SAM spec order, same ints as pysam)."""

    M, I, D, N, S, H, P, EQ, X = range(9)
    CHARS = "MIDNSHP=X"
    FROM_CHAR = {c: i for i, c in enumerate(CHARS)}
    CONSUMES_QUERY = (True, True, False, False, True, False, False, True, True)
    CONSUMES_REF = (True, False, True, True, False, False, False, True, True)


_CIGAR_RE = re.compile(r"(\d*)(\D)")  # digits (maybe none), then an op


def parse_cigar(cigar_str: str) -> list[tuple[int, int]]:
    if cigar_str == "*" or not cigar_str:
        return []
    return [(CIG.FROM_CHAR[ch], int(num) if num else 0)
            for num, ch in _CIGAR_RE.findall(cigar_str)]


def cigar_columns(cigar: list[tuple[int, int]]) -> tuple[np.ndarray, np.ndarray]:
    """Per alignment column of ``cigar`` (one for each base of its M, =,
    X, I, D and N ops; clips and pads make none): whether it takes a
    read base, and whether it takes a reference base."""
    n = len(cigar)
    ops = np.fromiter((op for op, _ in cigar), np.int64, n)
    lens = np.fromiter((length for _, length in cigar), np.int64, n)
    on_read = np.isin(ops, (CIG.M, CIG.EQ, CIG.X, CIG.I))
    on_ref = np.isin(ops, (CIG.M, CIG.EQ, CIG.X, CIG.D, CIG.N))
    cols = on_read | on_ref
    return (np.repeat(on_read[cols], lens[cols]),
            np.repeat(on_ref[cols], lens[cols]))


def cigar_to_string(cigar: list[tuple[int, int]]) -> str:
    if not cigar:
        return "*"
    return "".join("%d%s" % (length, CIG.CHARS[op]) for op, length in cigar)


@dataclass
class SamRecord:
    qname: str
    flag: int = 4
    rname: str = "*"  # reference sequence NAME (not index)
    pos: int = -1  # 0-based leftmost
    mapq: int = 0
    cigar: list[tuple[int, int]] = field(default_factory=list)
    seq: str = "*"
    qual: str = "*"
    tags: list[tuple[str, str, object]] = field(default_factory=list)
    rnext: str = "*"
    pnext: int = -1
    tlen: int = 0

    # --- flags -----------------------------------------------------------
    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 0x4) or self.rname == "*"

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 0x10)

    @is_reverse.setter
    def is_reverse(self, value: bool) -> None:
        self.flag = (self.flag | 0x10) if value else (self.flag & ~0x10)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & 0x100)

    # --- derived coordinates (pysam semantics) ---------------------------
    @property
    def qstart(self) -> int:
        """Length of leading soft clip (start of aligned part within seq)."""
        for op, length in self.cigar:
            if op == CIG.S:
                return length
            if op != CIG.H:
                return 0
        return 0

    @property
    def qend(self) -> int:
        """End (exclusive) of the aligned part within seq."""
        trailing = 0
        for op, length in reversed(self.cigar):
            if op == CIG.S:
                trailing = length
                break
            if op != CIG.H:
                break
        return len(self.seq) - trailing if self.seq != "*" else 0

    @property
    def aend(self) -> int:
        """End (exclusive) of the alignment on the reference."""
        return self.pos + sum(l for op, l in self.cigar if CIG.CONSUMES_REF[op])

    @property
    def query(self) -> str:
        """seq with soft-clipped ends removed."""
        return self.seq[self.qstart : self.qend]

    @property
    def query_alignment_length(self) -> int:
        return self.qend - self.qstart

    @property
    def aligned_pairs(self) -> list[tuple[Optional[int], Optional[int]]]:
        """(readPos, refPos) pairs; readPos relative to ``query``.

        Matches the pysam ``aligned_pairs`` iteration consumed by
        AlignedPair.iterator (reference utils.py:143).
        """
        pairs: list[tuple[Optional[int], Optional[int]]] = []
        read_pos = 0  # relative to query (post soft clip)
        ref_pos = self.pos
        for op, length in self.cigar:
            if op in (CIG.M, CIG.EQ, CIG.X):
                pairs.extend(
                    (read_pos + i, ref_pos + i) for i in range(length)
                )
                read_pos += length
                ref_pos += length
            elif op == CIG.I:
                pairs.extend((read_pos + i, None) for i in range(length))
                read_pos += length
            elif op in (CIG.D, CIG.N):
                pairs.extend((None, ref_pos + i) for i in range(length))
                ref_pos += length
            # S/H/P: excluded entirely
        return pairs

    def aligned_columns(self) -> tuple[np.ndarray, np.ndarray]:
        """``aligned_pairs`` as two int64 arrays, -1 where it has None."""
        on_read, on_ref = cigar_columns(self.cigar)
        read_pos = np.where(on_read, np.cumsum(on_read) - 1, -1)
        ref_pos = np.where(on_ref, self.pos + np.cumsum(on_ref) - 1, -1)
        return read_pos, ref_pos

    def aligned_pair_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized match-pair coordinates: (readPos[int32], refPos[int32]).

        Only M/=/X columns (both sides aligned) — the columns AlignedPair
        iterates (utils.py:143-154) — computed without a per-base Python loop.
        """
        on_read, on_ref = cigar_columns(self.cigar)
        match = on_read & on_ref
        read_pos = (np.cumsum(on_read) - 1)[match].astype(np.int32)
        ref_pos = (self.pos + np.cumsum(on_ref) - 1)[match].astype(np.int32)
        return read_pos, ref_pos

    # --- text form -------------------------------------------------------
    def to_line(self) -> str:
        fields = [
            self.qname,
            str(self.flag),
            self.rname,
            str(self.pos + 1),
            str(self.mapq),
            cigar_to_string(self.cigar),
            self.rnext,
            str(self.pnext + 1),
            str(self.tlen),
            self.seq if self.seq else "*",
            self.qual if self.qual else "*",
        ]
        for tag, typ, val in self.tags:
            fields.append("%s:%s:%s" % (tag, typ, val))
        return "\t".join(fields)

    @staticmethod
    def from_line(line: str) -> "SamRecord":
        f = line.rstrip("\n").split("\t")
        tags = []
        for t in f[11:]:
            tag, typ, val = t.split(":", 2)
            if typ == "i":
                val = int(val)
            elif typ == "f":
                val = float(val)
            tags.append((tag, typ, val))
        return SamRecord(
            qname=f[0],
            flag=int(f[1]),
            rname=f[2],
            pos=int(f[3]) - 1,
            mapq=int(f[4]),
            cigar=parse_cigar(f[5]),
            rnext=f[6],
            pnext=int(f[7]) - 1,
            tlen=int(f[8]),
            seq=f[9],
            qual=f[10],
            tags=tags,
        )

    def sort_key(self) -> tuple:
        """Deterministic ordering key: (rname, pos, qname).

        The reference sorts chained records with pysam AlignedRead.__lt__
        (utils.py:465) which orders by reference id / position; we pin a
        documented deterministic tie-break on qname.
        """
        return (self.rname, self.pos, self.qname)


class SamReader:
    """Iterate SamRecords from a SAM text file; header kept as lines."""

    def __init__(self, path: str):
        self.path = path
        self.header_lines: list[str] = []
        self.references: list[str] = []
        self.reference_lengths: dict[str, int] = {}
        self._body_offset = 0
        with open(path) as fh:
            off = 0
            for line in fh:
                if line.startswith("@"):
                    self.header_lines.append(line.rstrip("\n"))
                    if line.startswith("@SQ"):
                        sn, ln = None, None
                        for fld in line.rstrip("\n").split("\t")[1:]:
                            if fld.startswith("SN:"):
                                sn = fld[3:]
                            elif fld.startswith("LN:"):
                                ln = int(fld[3:])
                        if sn is not None:
                            self.references.append(sn)
                            self.reference_lengths[sn] = ln or 0
                    off += len(line)
                else:
                    break
            self._body_offset = off

    def __iter__(self) -> Iterator[SamRecord]:
        with open(self.path) as fh:
            fh.seek(self._body_offset)
            for line in fh:
                if line.strip():
                    yield SamRecord.from_line(line)

    def mapped(self) -> Iterator[SamRecord]:
        """Records with a reference alignment (samIterator, utils.py:287-293)."""
        for rec in self:
            if not rec.is_unmapped:
                yield rec


class SamWriter:
    """Write a SAM text file with an @SQ header built from a reference dict."""

    def __init__(self, path: str, references: dict[str, int] | list[str] = (),
                 template: "SamReader | None" = None):
        self._fh = open(path, "w")
        self._fh.write("@HD\tVN:1.6\tSO:unknown\n")
        if template is not None:
            for line in template.header_lines:
                if not line.startswith("@HD"):
                    self._fh.write(line + "\n")
        elif isinstance(references, dict):
            for name, length in references.items():
                self._fh.write("@SQ\tSN:%s\tLN:%d\n" % (name, length))

    def write(self, rec: SamRecord) -> None:
        self._fh.write(rec.to_line() + "\n")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def sam_records(path: str) -> list[SamRecord]:
    return list(SamReader(path))
