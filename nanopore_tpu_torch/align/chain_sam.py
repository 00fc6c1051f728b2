"""Chaining local alignments into one global alignment per (read, ref).

Reproduces the semantics of the reference alignment core
(reference nanopore/analyses/utils.py):

- ``chain_records``    = chainFn (utils.py:388-426): per-(read, refContig)
  bucket, score each local alignment by its number of aligned pairs, DP
  over ref-sorted alignments linking strictly-ordered, same-strand pairs
  with ref-gap + read-gap <= maxGap (default 200), backtrack the best.
- ``merge_chained``    = mergeChainedAlignedReads (utils.py:295-386):
  splice the chain into ONE SAM record spanning the whole reference
  (pos=0) and the whole read; inter-member gaps and unaligned ends become
  D/I runs; asserts cigar ref length == len(ref) and read length ==
  len(read) (utils.py:381-382) — the global-alignment invariant the
  realigner and EM rely on.
- ``chain_sam_file``   = chainSamFile (utils.py:441-469).

Deterministic tie-breaks are pinned and documented: equal-score chain
heads resolve to the latest in ref-sorted order (matching the reference's
stable sort + take-last, utils.py:417), and output records sort by
(rname, pos, qname).
"""

from __future__ import annotations

from nanopore_tpu_torch.io.sam import SamRecord, SamReader, SamWriter, CIG
from nanopore_tpu_torch.io.seqio import read_fasta_dict, read_fastq_dict
from nanopore_tpu_torch.io.encoding import reverse_complement

MAX_CHAIN_GAP = 200  # utils.py:388 maxGap default


def absolute_read_offset(rec: SamRecord, read_len: int) -> int:
    """Signed offset translating query positions to original-read coords.

    Semantics of utils.py:getAbsoluteReadOffset:156-166: absolute read
    position of query position p is abs(offset + p); the sign encodes
    strand (negative magnitudes on the reverse strand count from the
    read's end).
    """
    offset = rec.cigar[0][1] if rec.cigar and rec.cigar[0][0] == CIG.H else 0
    if rec.is_reverse:
        offset = -(read_len - 1 - offset)
    offset += rec.qstart
    return offset


def aligned_span(rec: SamRecord, read_len: int) -> tuple[int, int, int, int]:
    """(refStart, signedReadStart, refEnd, signedReadEnd) of a record.

    Coordinates of the first and last aligned pair, with read positions in
    signed absolute-read coordinates (utils.py:391-395,108-111).
    """
    offset = absolute_read_offset(rec, read_len)
    q = 0  # query-relative position
    r = rec.pos
    first = last = None
    for op, length in rec.cigar:
        if op in (CIG.M, CIG.EQ, CIG.X):
            if first is None:
                first = (r, q)
            last = (r + length - 1, q + length - 1)
            q += length
            r += length
        elif op == CIG.I:
            q += length
        elif op in (CIG.D, CIG.N):
            r += length
    assert first is not None, "record has no aligned pairs"
    sign = -1 if rec.is_reverse else 1
    return (
        first[0],
        sign * abs(offset + first[1]),
        last[0],
        sign * abs(offset + last[1]),
    )


def alignment_score(rec: SamRecord) -> int:
    """Number of aligned pairs — the default chain score (utils.py:388)."""
    return sum(l for op, l in rec.cigar if op in (CIG.M, CIG.EQ, CIG.X))


def chain_records(
    records: list[SamRecord],
    read_len: int,
    max_gap: int = MAX_CHAIN_GAP,
) -> list[SamRecord]:
    """Highest-scoring chain of local alignments (chainFn semantics)."""
    spans = {id(r): aligned_span(r, read_len) for r in records}
    scores = {id(r): float(alignment_score(r)) for r in records}
    pointers: dict[int, SamRecord] = {}

    ordered = sorted(records, key=lambda r: spans[id(r)][0])
    for i, rec in enumerate(ordered):
        r_start, q_start, _, _ = spans[id(rec)]
        base = float(alignment_score(rec))
        for j in range(i):
            prev = ordered[j]
            _, _, r_end2, q_end2 = spans[id(prev)]
            if (
                r_start > r_end2
                and q_start > q_end2
                and rec.is_reverse == prev.is_reverse
                and (r_start - r_end2) + (q_start - q_end2) <= max_gap
                and base + scores[id(prev)] > scores[id(rec)]
            ):
                scores[id(rec)] = base + scores[id(prev)]
                pointers[id(rec)] = prev

    # best head: max score, ties resolved to the LAST in ref-sorted order
    best = ordered[0]
    for rec in ordered:
        if scores[id(rec)] >= scores[id(best)]:
            best = rec

    chain = [best]
    while id(chain[-1]) in pointers:
        chain.append(pointers[id(chain[-1])])
    chain.reverse()
    return chain


def merge_chained(
    chain: list[SamRecord], ref_seq: str, read_seq: str
) -> SamRecord:
    """Splice a chain into one global SAM record (mergeChainedAlignedReads)."""
    first = chain[0]
    is_reverse = first.is_reverse
    out = SamRecord(
        qname=first.qname,
        flag=0x10 if is_reverse else 0,
        rname=first.rname,
        pos=0,
        mapq=first.mapq,
        seq=reverse_complement(read_seq) if is_reverse else read_seq,
        qual="*",
    )
    cigar: list[tuple[int, int]] = []
    p_pos = 0
    p_qpos = -(len(read_seq) - 1) if is_reverse else 0

    for rec in chain:
        assert rec.is_reverse == is_reverse
        assert rec.pos >= p_pos, "chain not ref-ordered"
        if rec.pos > p_pos:
            cigar.append((CIG.D, rec.pos - p_pos))
            p_pos = rec.pos
        q_pos = absolute_read_offset(rec, len(read_seq))
        assert q_pos >= p_qpos, "chain not read-ordered"
        if q_pos > p_qpos:
            cigar.append((CIG.I, q_pos - p_qpos))
            p_qpos = q_pos
        for op, length in rec.cigar:
            assert op in (CIG.M, CIG.I, CIG.D, CIG.S, CIG.H), (
                "unsupported op %d" % op
            )
            if op in (CIG.M, CIG.I, CIG.D):
                cigar.append((op, length))
            if op in (CIG.M, CIG.D):
                p_pos += length
            if op in (CIG.M, CIG.I):
                p_qpos += length

    assert p_pos <= len(ref_seq)
    if p_pos < len(ref_seq):
        cigar.append((CIG.D, len(ref_seq) - p_pos))
    if is_reverse:
        assert p_qpos <= 1
        if p_qpos < 1:
            cigar.append((CIG.I, 1 - p_qpos))
    else:
        assert p_qpos <= len(read_seq)
        if p_qpos < len(read_seq):
            cigar.append((CIG.I, len(read_seq) - p_qpos))

    # merge adjacent same-op runs for a canonical cigar
    merged: list[tuple[int, int]] = []
    for op, length in cigar:
        if merged and merged[-1][0] == op:
            merged[-1] = (op, merged[-1][1] + length)
        else:
            merged.append((op, length))

    ref_len = sum(l for op, l in merged if op in (CIG.M, CIG.D))
    read_len_c = sum(l for op, l in merged if op in (CIG.M, CIG.I))
    assert ref_len == len(ref_seq), (ref_len, len(ref_seq))
    assert read_len_c == len(read_seq), (read_len_c, len(read_seq))
    out.cigar = merged
    return out


def chain_sam_file(
    sam_path: str,
    output_sam_path: str,
    read_fastq_path: str,
    reference_fasta_path: str,
    max_gap: int = MAX_CHAIN_GAP,
) -> None:
    """chainSamFile semantics (utils.py:441-469)."""
    reader = SamReader(sam_path)
    ref_seqs = read_fasta_dict(reference_fasta_path)
    read_seqs = read_fastq_dict(read_fastq_path)

    buckets: dict[tuple[str, str], list[SamRecord]] = {}
    for rec in reader.mapped():
        if rec.qname not in read_seqs:
            raise RuntimeError(
                "Aligned read name %s not in read sequences" % rec.qname
            )
        buckets.setdefault((rec.qname, rec.rname), []).append(rec)

    chained = []
    for (qname, rname), records in buckets.items():
        ref_seq = ref_seqs[rname]
        read_seq = read_seqs[qname]
        chain = chain_records(records, len(read_seq), max_gap)
        chained.append(merge_chained(chain, ref_seq, read_seq))
    chained.sort(key=SamRecord.sort_key)

    with SamWriter(output_sam_path, template=reader) as writer:
        for rec in chained:
            writer.write(rec)


def combine_sam_files(
    base_sam: str, extra_sams: list[str], output_sam: str
) -> None:
    """Concatenate records of several SAM files (utils.py:428-439)."""
    reader = SamReader(base_sam)
    with SamWriter(output_sam, template=reader) as writer:
        for path in [base_sam] + list(extra_sams):
            for rec in SamReader(path):
                writer.write(rec)
