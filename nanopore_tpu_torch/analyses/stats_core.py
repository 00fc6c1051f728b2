"""Vectorised per-alignment counters — the AlignedPair replacement.

The reference walks every aligned pair in a Python loop through
``AlignedPair.iterator`` (reference nanopore/analyses/utils.py:
81-154) for each of substitutions / coverage / indels — ranked hot loop
no.3 of the system (SURVEY.md section 3).  Here the same quantities come
from O(#cigar-runs) NumPy segment arithmetic plus one vectorised base
comparison.  A copy of the JAX package's ``analyses/stats_core.py``.

Semantics notes (verified against the reference):
- "read base" of an aligned pair is the SAM-oriented (query) base —
  AlignedPair.getReadBase == alignedRead.query[readPos] (utils.py:150-152).
- match requires equal bases with the ref base in ACGT; mismatch requires
  both in ACGT; everything else counts as an N column (utils.py:94-98).
- insertion/deletion *events* are per gap between consecutive aligned
  pairs: all I (resp. D) cigar runs between two match columns collapse
  into one event whose length is the total (utils.py:113-134).
- in global mode, unaligned leading/trailing read/ref also count as one
  event each (coverage.py:38-59); in local mode they are ignored.
- block lengths are the lengths of match runs that are FOLLOWED by
  another match run (the last block is never recorded — indels.py:19-31).
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass

from nanopore_tpu_torch.io.encoding import encode
from nanopore_tpu_torch.io.sam import SamRecord, CIG


@dataclass
class AlignmentCounts:
    qname: str
    rname: str
    read_len: int  # original read length
    ref_len: int
    matches: int
    mismatches: int
    ns: int
    interior_ins_lengths: np.ndarray  # one entry per insertion event
    interior_del_lengths: np.ndarray
    leading_ins: int  # unaligned read bases before the first aligned pair
    leading_del: int  # unaligned ref bases before the first aligned pair
    trailing_ins: int
    trailing_del: int
    block_lengths: np.ndarray
    pair_ref_codes: np.ndarray  # int8 per aligned pair
    pair_read_codes: np.ndarray


def count_alignment(
    rec: SamRecord,
    ref_codes: np.ndarray,
    read_len: int,
    query_codes: np.ndarray | None = None,
) -> AlignmentCounts:
    """All per-alignment counters for one SAM record."""
    ops = np.array([op for op, _ in rec.cigar], np.int32)
    lens = np.array([l for _, l in rec.cigar], np.int64)
    if query_codes is None:
        query_codes = encode(rec.query)

    read_pos, ref_pos = rec.aligned_pair_arrays()
    # clip the rare mapper off-by-one the reference tolerates
    # (utils.py:146-148: aligned reference position out of bounds)
    in_bounds = ref_pos < len(ref_codes)
    read_pos, ref_pos = read_pos[in_bounds], ref_pos[in_bounds]
    pr = ref_codes[ref_pos]
    pq = query_codes[read_pos]
    matches = int(((pr == pq) & (pr < 4)).sum())
    mismatches = int(((pr != pq) & (pr < 4) & (pq < 4)).sum())
    ns = len(pr) - matches - mismatches

    m_mask = np.isin(ops, (CIG.M, CIG.EQ, CIG.X))
    m_idx = np.nonzero(m_mask)[0]
    ins_lens = np.where(ops == CIG.I, lens, 0)
    del_lens = np.where(np.isin(ops, (CIG.D, CIG.N)), lens, 0)
    cum_i = np.concatenate([[0], np.cumsum(ins_lens)])
    cum_d = np.concatenate([[0], np.cumsum(del_lens)])

    # clip lengths count as unaligned read bases in global mode: the
    # reference derives leading/trailing from ABSOLUTE read coordinates
    # (coverage.py:44-59 via AlignedPair.getPreceding*, utils.py:113-128),
    # which include soft/hard-clipped bases.
    clip_lens = np.where(np.isin(ops, (CIG.S, CIG.H)), lens, 0)
    cum_c = np.concatenate([[0], np.cumsum(clip_lens)])

    if len(m_idx) == 0:
        interior_ins = np.empty(0, np.int64)
        interior_del = np.empty(0, np.int64)
        leading_ins = leading_del = trailing_ins = trailing_del = 0
        blocks = np.empty(0, np.int64)
    else:
        first_m, last_m = m_idx[0], m_idx[-1]
        # gap totals between consecutive match runs
        seg_i = cum_i[m_idx[1:]] - cum_i[m_idx[:-1] + 1]
        seg_d = cum_d[m_idx[1:]] - cum_d[m_idx[:-1] + 1]
        interior_ins = seg_i[seg_i > 0]
        interior_del = seg_d[seg_d > 0]
        leading_ins = int(cum_i[first_m] + cum_c[first_m])
        leading_del = int(cum_d[first_m]) + max(rec.pos, 0)
        trailing_ins = int(
            (cum_i[-1] - cum_i[last_m + 1]) + (cum_c[-1] - cum_c[last_m + 1])
        )
        trailing_del = int(cum_d[-1] - cum_d[last_m + 1]) + max(
            len(ref_codes) - rec.aend, 0
        )
        blocks = lens[m_idx[:-1]]

    return AlignmentCounts(
        qname=rec.qname,
        rname=rec.rname,
        read_len=read_len,
        ref_len=len(ref_codes),
        matches=matches,
        mismatches=mismatches,
        ns=ns,
        interior_ins_lengths=interior_ins,
        interior_del_lengths=interior_del,
        leading_ins=leading_ins,
        leading_del=leading_del,
        trailing_ins=trailing_ins,
        trailing_del=trailing_del,
        block_lengths=blocks,
        pair_ref_codes=pr,
        pair_read_codes=pq,
    )


def _nan_ratio(num: float, den: float) -> float:
    """AbstractAnalysis.formatRatio (abstractAnalysis.py:37-41)."""
    return float("nan") if den == 0 else float(num) / den


@dataclass
class CoverageView:
    """ReadAlignmentCoverageCounter-equivalent derived metrics
    (reference coverage.py:10-95)."""

    counts: AlignmentCounts
    global_mode: bool

    @property
    def total_ins_events(self) -> int:
        events = len(self.counts.interior_ins_lengths)
        if self.global_mode:
            events += int(self.counts.leading_ins > 0)
            events += int(self.counts.trailing_ins > 0)
        return events

    @property
    def total_del_events(self) -> int:
        events = len(self.counts.interior_del_lengths)
        if self.global_mode:
            events += int(self.counts.leading_del > 0)
            events += int(self.counts.trailing_del > 0)
        return events

    @property
    def total_ins_length(self) -> int:
        total = int(self.counts.interior_ins_lengths.sum())
        if self.global_mode:
            total += self.counts.leading_ins + self.counts.trailing_ins
        return total

    @property
    def total_del_length(self) -> int:
        total = int(self.counts.interior_del_lengths.sum())
        if self.global_mode:
            total += self.counts.leading_del + self.counts.trailing_del
        return total

    # metric names follow the reference XML attributes (coverage.py:66-95)
    def readCoverage(self) -> float:
        ali = self.counts.matches + self.counts.mismatches
        return _nan_ratio(ali, ali + self.total_ins_length)

    def referenceCoverage(self) -> float:
        ali = self.counts.matches + self.counts.mismatches
        return _nan_ratio(ali, ali + self.total_del_length)

    def identity(self) -> float:
        ali = self.counts.matches + self.counts.mismatches
        return _nan_ratio(self.counts.matches, ali + self.total_ins_length)

    def mismatchesPerReadBase(self) -> float:
        ali = self.counts.matches + self.counts.mismatches
        return _nan_ratio(self.counts.mismatches, ali)

    def deletionsPerReadBase(self) -> float:
        ali = self.counts.matches + self.counts.mismatches
        return _nan_ratio(self.total_del_events, ali)

    def insertionsPerReadBase(self) -> float:
        ali = self.counts.matches + self.counts.mismatches
        return _nan_ratio(self.total_ins_events, ali)

    def readLength(self) -> int:
        return self.counts.read_len
