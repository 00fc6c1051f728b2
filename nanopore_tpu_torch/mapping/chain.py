"""Seed-hit anchoring and chaining for the unified mapper.

Replaces the seeding/chaining stages of bwa-mem / LAST / lastz / BLASR
(reference ``nanopore/mappers/*``; their tuned variants become presets,
SURVEY.md section 7): exact-match seed hits are merged into maximal
same-diagonal anchors (vectorised), then chained with an O(A^2) DP over
the (small) anchor set with concave gap costs, minimap-style.  The best
chain and strong non-overlapping secondaries become candidate alignments
handed to the banded extension kernel.
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass


@dataclass
class Anchor:
    """A maximal run of same-diagonal k-mer hits (exact match)."""

    q_start: int
    r_start: int
    length: int  # in bases

    @property
    def q_end(self) -> int:  # exclusive
        return self.q_start + self.length

    @property
    def r_end(self) -> int:
        return self.r_start + self.length


def merge_hits_to_anchors(
    ref_pos: np.ndarray, read_pos: np.ndarray, k: int
) -> list[Anchor]:
    """Merge k-mer hits into maximal same-diagonal anchors (vectorised)."""
    if len(ref_pos) == 0:
        return []
    diag = ref_pos.astype(np.int64) - read_pos
    order = np.lexsort((read_pos, diag))
    d, q, r = diag[order], read_pos[order], ref_pos[order]
    # a new run starts when the diagonal changes or read positions are not
    # contiguous-or-overlapping
    breaks = np.empty(len(d), bool)
    breaks[0] = True
    breaks[1:] = (d[1:] != d[:-1]) | (q[1:] > q[:-1] + k)
    run_ids = np.cumsum(breaks) - 1
    n_runs = run_ids[-1] + 1
    q_start = np.full(n_runs, np.iinfo(np.int64).max)
    np.minimum.at(q_start, run_ids, q)
    q_last = np.zeros(n_runs, np.int64)
    np.maximum.at(q_last, run_ids, q)
    r_start = np.full(n_runs, np.iinfo(np.int64).max)
    np.minimum.at(r_start, run_ids, r)
    lengths = q_last - q_start + k
    return [
        Anchor(int(qs), int(rs), int(ln))
        for qs, rs, ln in zip(q_start, r_start, lengths)
    ]


@dataclass
class Chain:
    anchors: list[Anchor]
    score: float

    @property
    def q_start(self) -> int:
        return self.anchors[0].q_start

    @property
    def q_end(self) -> int:
        return self.anchors[-1].q_end

    @property
    def r_start(self) -> int:
        return self.anchors[0].r_start

    @property
    def r_end(self) -> int:
        return self.anchors[-1].r_end


def chain_anchors(
    anchors: list[Anchor],
    max_ref_gap: int = 5000,
    max_diag_drift: int = 500,
    gap_open: float = 1.0,
    gap_scale: float = 0.05,
    max_anchors: int = 2000,
    min_chain_score: float = 20.0,
    max_chains: int = 8,
) -> list[Chain]:
    """Chain anchors into candidate alignments (native DP).

    Scoring: anchor length, minus a concave gap cost
    ``gap_open + gap_scale * min(dq, dr) + 0.5 * |dq - dr|`` between
    linked anchors.  Returns chains sorted by score, best first; later
    chains reuse no anchor of an earlier one (non-overlapping in the
    read), giving the multiple local alignments the pipeline's chaining
    stage expects (reference utils.py:441-469 consumes several records
    per read).
    """
    if not anchors:
        return []
    anchors = sorted(anchors, key=lambda a: (a.r_start, a.q_start))
    if len(anchors) > max_anchors:
        anchors = sorted(
            anchors, key=lambda a: a.length, reverse=True
        )[:max_anchors]
        anchors = sorted(anchors, key=lambda a: (a.r_start, a.q_start))
    A = len(anchors)
    qs = np.array([a.q_start for a in anchors])
    qe = np.array([a.q_end for a in anchors])
    rs = np.array([a.r_start for a in anchors])
    re = np.array([a.r_end for a in anchors])
    ln = np.array([a.length for a in anchors], np.float64)

    from nanopore_tpu_torch.runtime import native_index

    score, parent = native_index.chain_dp(
        qs, qe, rs, re, ln, max_ref_gap, max_diag_drift, gap_open, gap_scale
    )

    used = np.zeros(A, bool)
    chains: list[Chain] = []
    for i in np.argsort(-score):
        if used[i] or score[i] < min_chain_score:
            continue
        members = []
        p = i
        overlap = False
        while p != -1:
            if used[p]:
                overlap = True
                break
            members.append(p)
            p = parent[p]
        if overlap or not members:
            continue
        members.reverse()
        for p in members:
            used[p] = True
        chains.append(
            Chain([anchors[p] for p in members], float(score[i]))
        )
        if len(chains) >= max_chains:
            break
    return chains
