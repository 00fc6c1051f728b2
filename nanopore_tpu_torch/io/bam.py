"""Native BAM / BGZF / BAI codec (no samtools, no pysam).

A copy of the JAX package's ``io/bam.py``.

The reference vendors samtools-0.1.19 (~28.5k LoC of C) and shells out to
it for BAM conversion, sorting, indexing and depth
(reference nanopore/analyses/utils.py:222 ``samToBamFile``,
metaAnalyses/coverageDepth.py:65, metaAnalyses/customTrackAssemblyHub.py:93-101).
This module re-implements the on-disk formats those calls produce —
BGZF-compressed BAM records plus the BAI binning index — directly from
the SAM-spec (the same layout samtools-0.1.19 encodes in
``submodules/samtools-0.1.19/bam.h`` / ``bgzf.c`` / ``bam_index.c``),
so hub tracks and downstream tools (IGV, UCSC, samtools) can consume our
output byte-for-byte compatibly.

Everything here is host-side I/O — TPU analyses never read BAM; they
consume the padded alignment tensors built from SamRecords.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, Optional

from nanopore_tpu_torch.io.sam import CIG, SamRecord, SamReader

# ---------------------------------------------------------------------------
# BGZF — blocked gzip with a BC extra subfield carrying the block size.
# ---------------------------------------------------------------------------

# gzip fixed header (ID1 ID2 CM FLG MTIME XFL OS), XLEN, then the BC
# subfield (SI1 SI2 SLEN BSIZE-1)
_BGZF_HDR = struct.Struct("<4BI2BH2B2H")
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
_MAX_BLOCK = 0xFF00  # uncompressed payload per block (samtools uses 64 KiB - 256)


class BgzfWriter:
    """Write a BGZF stream: independently-deflated <=64 KiB blocks.

    ``tell_virtual()`` returns the virtual file offset
    (coffset << 16 | uoffset) BAI indexing needs.
    """

    def __init__(self, path_or_fh, level: int = 6):
        self._own = isinstance(path_or_fh, (str, os.PathLike))
        self._fh = open(path_or_fh, "wb") if self._own else path_or_fh
        self._buf = bytearray()
        self._coffset = 0
        self._level = level

    def tell_virtual(self) -> int:
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= _MAX_BLOCK:
            self._flush_block(bytes(self._buf[:_MAX_BLOCK]))
            del self._buf[:_MAX_BLOCK]

    def _flush_block(self, payload: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        comp = co.compress(payload) + co.flush()
        bsize = len(comp) + 25 + 1  # header(12)+BC(6)+deflate+crc(4)+isize(4)
        header = _BGZF_HDR.pack(
            31, 139, 8, 4,  # gzip magic, deflate, FEXTRA
            0, 0, 255,      # mtime, XFL, OS=unknown
            6,              # XLEN
            66, 67, 2,      # 'B','C', SLEN=2
            bsize - 1,
        )
        self._fh.write(header)
        self._fh.write(comp)
        self._fh.write(struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                                   len(payload) & 0xFFFFFFFF))
        self._coffset += len(header) + len(comp) + 8

    def close(self) -> None:
        if self._fh is None:
            return
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.write(_BGZF_EOF)
        if self._own:
            self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BgzfReader:
    """Read a BGZF stream with virtual-offset seeks."""

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        self._block = b""
        self._block_coffset = 0
        self._within = 0
        self._next_coffset = 0
        self._load_block(0)

    def _load_block(self, coffset: int) -> bool:
        self._fh.seek(coffset)
        header = self._fh.read(12)
        if len(header) < 12:
            self._block = b""
            self._block_coffset = coffset
            self._within = 0
            return False
        magic1, magic2, _cm, flg, _mt, _xfl, _os, xlen = struct.unpack(
            "<2B2BI2BH", header
        )
        if (magic1, magic2) != (31, 139) or not flg & 4:
            raise ValueError("not a BGZF block at offset %d" % coffset)
        extra = self._fh.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack(
                "<H", extra[i + 2 : i + 4]
            )[0]
            if (si1, si2) == (66, 67):
                bsize = struct.unpack("<H", extra[i + 4 : i + 6])[0] + 1
            i += 4 + slen
        if bsize is None:
            raise ValueError("missing BC subfield (not BGZF)")
        comp = self._fh.read(bsize - 12 - xlen - 8)
        crc, isize = struct.unpack("<II", self._fh.read(8))
        payload = zlib.decompress(comp, -15)
        if len(payload) != isize or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise ValueError("BGZF block checksum mismatch")
        self._block = payload
        self._block_coffset = coffset
        self._within = 0
        self._next_coffset = coffset + bsize
        return True

    def seek_virtual(self, voffset: int) -> None:
        coffset, within = voffset >> 16, voffset & 0xFFFF
        if coffset != self._block_coffset or not self._block:
            self._load_block(coffset)
        self._within = within

    def tell_virtual(self) -> int:
        return (self._block_coffset << 16) | self._within

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            avail = len(self._block) - self._within
            if avail <= 0:
                if not self._load_block(self._next_coffset):
                    break
                continue
            take = min(avail, n)
            out += self._block[self._within : self._within + take]
            self._within += take
            n -= take
        return bytes(out)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# BAM record codec
# ---------------------------------------------------------------------------

_SEQ_CODE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_SEQ_CHAR = "=ACMGRSVTWYHKDBN"


def _encode_seq(seq: str) -> bytes:
    n = len(seq)
    out = bytearray((n + 1) // 2)
    for i, ch in enumerate(seq.upper()):
        code = _SEQ_CODE.get(ch, 15)  # unknown -> N
        if i & 1:
            out[i >> 1] |= code
        else:
            out[i >> 1] = code << 4
    return bytes(out)


def _decode_seq(data: bytes, l_seq: int) -> str:
    out = []
    for i in range(l_seq):
        b = data[i >> 1]
        out.append(_SEQ_CHAR[(b >> 4) if not i & 1 else (b & 0xF)])
    return "".join(out)


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning (bam.h reg2bin, samtools-0.1.19)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _encode_tags(tags) -> bytes:
    out = bytearray()
    for tag, typ, val in tags:
        out += tag.encode()
        if typ == "i":
            v = int(val)
            if -128 <= v < 128:
                out += b"c" + struct.pack("<b", v)
            elif -32768 <= v < 32768:
                out += b"s" + struct.pack("<h", v)
            else:
                out += b"i" + struct.pack("<i", v)
        elif typ == "f":
            out += b"f" + struct.pack("<f", float(val))
        elif typ == "A":
            out += b"A" + str(val)[:1].encode()
        else:  # Z and anything stringly
            out += b"Z" + str(val).encode() + b"\x00"
    return bytes(out)


def _decode_tags(data: bytes):
    tags = []
    i = 0
    int_fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I"}
    while i + 3 <= len(data):
        tag = data[i : i + 2].decode()
        typ = chr(data[i + 2])
        i += 3
        if typ in int_fmt:
            fmt = int_fmt[typ]
            size = struct.calcsize(fmt)
            tags.append((tag, "i", struct.unpack(fmt, data[i : i + size])[0]))
            i += size
        elif typ == "f":
            tags.append((tag, "f", struct.unpack("<f", data[i : i + 4])[0]))
            i += 4
        elif typ == "A":
            tags.append((tag, "A", chr(data[i])))
            i += 1
        elif typ in "ZH":
            end = data.index(b"\x00", i)
            tags.append((tag, "Z", data[i:end].decode()))
            i = end + 1
        elif typ == "B":
            sub = chr(data[i])
            n = struct.unpack("<I", data[i + 1 : i + 5])[0]
            fmt = int_fmt.get(sub, "<f")
            size = struct.calcsize(fmt)
            vals = [
                struct.unpack(fmt, data[i + 5 + k * size : i + 5 + (k + 1) * size])[0]
                for k in range(n)
            ]
            tags.append((tag, "B", (sub, vals)))
            i += 5 + n * size
        else:
            raise ValueError("unknown BAM tag type %r" % typ)
    return tags


def encode_bam_record(rec: SamRecord, ref_ids: dict[str, int]) -> bytes:
    """One alignment block (sans leading block_size), per SAM-spec §4.2."""
    refid = ref_ids.get(rec.rname, -1)
    pos = rec.pos if rec.pos >= 0 else -1
    name = rec.qname.encode() + b"\x00"
    n_cigar = len(rec.cigar)
    seq = "" if rec.seq == "*" else rec.seq
    l_seq = len(seq)
    if pos >= 0 and rec.cigar:
        bin_ = reg2bin(pos, rec.aend)
    else:
        bin_ = reg2bin(pos, pos + 1) if pos >= 0 else 4680
    next_refid = (
        refid if rec.rnext == "=" else ref_ids.get(rec.rnext, -1)
    )
    fixed = struct.pack(
        "<iiBBHHHiiii",
        refid,
        pos,
        len(name),
        rec.mapq,
        bin_,
        n_cigar,
        rec.flag,
        l_seq,
        next_refid,
        rec.pnext if rec.pnext >= 0 else -1,
        rec.tlen,
    )
    cig = b"".join(
        struct.pack("<I", (length << 4) | op) for op, length in rec.cigar
    )
    if rec.qual == "*" or not rec.qual:
        qual = b"\xff" * l_seq
    else:
        qual = bytes((min(ord(c) - 33, 93) for c in rec.qual))
        if len(qual) != l_seq:  # malformed input: pad/truncate defensively
            qual = (qual + b"\xff" * l_seq)[:l_seq]
    return fixed + name + cig + _encode_seq(seq) + qual + _encode_tags(rec.tags)


def decode_bam_record(data: bytes, ref_names: list[str]) -> SamRecord:
    (refid, pos, l_name, mapq, _bin, n_cigar, flag, l_seq,
     next_refid, next_pos, tlen) = struct.unpack("<iiBBHHHiiii", data[:32])
    i = 32
    qname = data[i : i + l_name - 1].decode()
    i += l_name
    cigar = []
    for _ in range(n_cigar):
        v = struct.unpack("<I", data[i : i + 4])[0]
        cigar.append((v & 0xF, v >> 4))
        i += 4
    seq = _decode_seq(data[i : i + (l_seq + 1) // 2], l_seq)
    i += (l_seq + 1) // 2
    qual_raw = data[i : i + l_seq]
    i += l_seq
    qual = (
        "*"
        if not l_seq or all(q == 0xFF for q in qual_raw)
        else "".join(chr(min(q, 93) + 33) for q in qual_raw)
    )
    return SamRecord(
        qname=qname,
        flag=flag,
        rname=ref_names[refid] if refid >= 0 else "*",
        pos=pos,
        mapq=mapq,
        cigar=cigar,
        seq=seq or "*",
        qual=qual,
        tags=_decode_tags(data[i:]),
        rnext=ref_names[next_refid] if next_refid >= 0 else "*",
        pnext=next_pos,
        tlen=tlen,
    )


# ---------------------------------------------------------------------------
# BAM files
# ---------------------------------------------------------------------------


class BamWriter:
    """Write a BAM file; tracks per-record virtual offsets for indexing."""

    def __init__(self, path: str, references: dict[str, int],
                 header_text: str = "", level: int = 6):
        self._bgzf = BgzfWriter(path, level=level)
        self.references = list(references)
        self._ref_ids = {n: i for i, n in enumerate(self.references)}
        self._ref_lens = dict(references)
        if not header_text:
            header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
                "@SQ\tSN:%s\tLN:%d\n" % (n, l) for n, l in references.items()
            )
        text = header_text.encode()
        self._bgzf.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
        self._bgzf.write(struct.pack("<i", len(self.references)))
        for name in self.references:
            nm = name.encode() + b"\x00"
            self._bgzf.write(
                struct.pack("<i", len(nm)) + nm
                + struct.pack("<i", self._ref_lens[name])
            )
        # (refid, beg, end, voffset_start, voffset_end) per record, for BAI
        self._index_entries: list[tuple[int, int, int, int, int]] = []

    def write(self, rec: SamRecord) -> None:
        start = self._bgzf.tell_virtual()
        body = encode_bam_record(rec, self._ref_ids)
        self._bgzf.write(struct.pack("<i", len(body)) + body)
        end = self._bgzf.tell_virtual()
        refid = self._ref_ids.get(rec.rname, -1)
        if refid >= 0 and rec.pos >= 0:
            aend = rec.aend if rec.cigar else rec.pos + 1
            self._index_entries.append((refid, rec.pos, aend, start, end))

    def close(self) -> None:
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write_index(self, bai_path: str) -> None:
        """Emit the .bai binning index (bam_index.c semantics)."""
        n_ref = len(self.references)
        bins: list[dict[int, list[tuple[int, int]]]] = [
            {} for _ in range(n_ref)
        ]
        linear: list[dict[int, int]] = [{} for _ in range(n_ref)]
        for refid, beg, end, vs, ve in self._index_entries:
            b = reg2bin(beg, end)
            bins[refid].setdefault(b, []).append((vs, ve))
            for win in range(beg >> 14, ((end - 1) >> 14) + 1):
                if win not in linear[refid] or vs < linear[refid][win]:
                    linear[refid][win] = vs
        with open(bai_path, "wb") as fh:
            fh.write(b"BAI\x01" + struct.pack("<i", n_ref))
            for refid in range(n_ref):
                fh.write(struct.pack("<i", len(bins[refid])))
                for b in sorted(bins[refid]):
                    chunks = _merge_chunks(bins[refid][b])
                    fh.write(struct.pack("<Ii", b, len(chunks)))
                    for vs, ve in chunks:
                        fh.write(struct.pack("<QQ", vs, ve))
                if linear[refid]:
                    n_intv = max(linear[refid]) + 1
                    fh.write(struct.pack("<i", n_intv))
                    filled = 0
                    for win in range(n_intv):
                        filled = linear[refid].get(win, filled)
                        fh.write(struct.pack("<Q", filled))
                else:
                    fh.write(struct.pack("<i", 0))


def _merge_chunks(chunks: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Coalesce adjacent chunks sharing a compressed block (bam_index.c)."""
    chunks = sorted(chunks)
    out = [list(chunks[0])]
    for vs, ve in chunks[1:]:
        if vs >> 16 <= out[-1][1] >> 16:
            out[-1][1] = max(out[-1][1], ve)
        else:
            out.append([vs, ve])
    return [tuple(c) for c in out]


class BamReader:
    """Iterate SamRecords from a BAM file."""

    def __init__(self, path: str):
        self._bgzf = BgzfReader(path)
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise ValueError("%s: not a BAM file" % path)
        (l_text,) = struct.unpack("<i", self._bgzf.read(4))
        self.header_text = self._bgzf.read(l_text).decode()
        (n_ref,) = struct.unpack("<i", self._bgzf.read(4))
        self.references: list[str] = []
        self.reference_lengths: dict[str, int] = {}
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._bgzf.read(4))
            name = self._bgzf.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", self._bgzf.read(4))
            self.references.append(name)
            self.reference_lengths[name] = l_ref
        self._body_voffset = self._bgzf.tell_virtual()

    def __iter__(self) -> Iterator[SamRecord]:
        self._bgzf.seek_virtual(self._body_voffset)
        while True:
            raw = self._bgzf.read(4)
            if len(raw) < 4:
                return
            (block_size,) = struct.unpack("<i", raw)
            data = self._bgzf.read(block_size)
            if len(data) < block_size:
                return
            yield decode_bam_record(data, self.references)

    def close(self) -> None:
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# samtools-equivalent conveniences
# ---------------------------------------------------------------------------


def sam_to_sorted_bam(sam_path: str, bam_path: str,
                      bai_path: Optional[str] = None) -> str:
    """samToBamFile + samtools sort + samtools index in one pass
    (reference utils.py:222-230, customTrackAssemblyHub.py:93-101).

    Coordinate sort (refid, pos, qname) with a pinned qname tie-break.
    """
    reader = SamReader(sam_path)
    refs = {n: reader.reference_lengths.get(n, 0) for n in reader.references}
    ref_ids = {n: i for i, n in enumerate(reader.references)}
    records = sorted(
        reader,
        key=lambda r: (
            ref_ids.get(r.rname, len(ref_ids)),
            r.pos if r.pos >= 0 else 1 << 60,
            r.qname,
        ),
    )
    header_text = (
        "@HD\tVN:1.6\tSO:coordinate\n"
        + "".join(
            line + "\n"
            for line in reader.header_lines
            if not line.startswith("@HD")
        )
    )
    with BamWriter(bam_path, refs, header_text=header_text) as bw:
        for rec in records:
            bw.write(rec)
        if bai_path is None:
            bai_path = bam_path + ".bai"
        bw.write_index(bai_path)
    return bam_path


def bam_records(path: str) -> list[SamRecord]:
    with BamReader(path) as br:
        return list(br)
