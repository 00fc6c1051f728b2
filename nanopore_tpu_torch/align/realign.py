"""Batched realignment: chain, then MEA-redecode every global alignment.

Counterpart of ``nanopore_tpu/align/realign.py``.  Replaces the
reference's realignment fan-out (reference
nanopore/analyses/utils.py:540-609): where the reference chains the SAM,
then forks one OS process per record piping an exonerate cigar through
``cactus_realign --diagonalExpansion=10 --splitMatrixBiggerThanThis=3000
--gapGamma --matchGamma`` (utils.py:587) and splices the results back in
order, we chain, batch all records through the fused realign kernel in
decode mode and the MEA walker on the device, and rewrite cigars in
order — no process fan-out, no temp-file relay.

``rescore=True`` also returns each record's average posterior match
probability along its new alignment: the decode launch writes the
gamma_match band too (the kernel's decode + gamma mode) and the rescore
is a reduction on the device.  With several local cards the batches
round-robin over them (``ops.dispatch.local_dp_devices``).
"""

from __future__ import annotations

import itertools
import os
import tempfile

import numpy as np

from nanopore_tpu_torch.align.chain_sam import chain_sam_file
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.device import resolve_device
from nanopore_tpu_torch.io.encoding import encode
from nanopore_tpu_torch.io.sam import CIG as _C
from nanopore_tpu_torch.io.sam import SamReader, SamRecord, SamWriter
from nanopore_tpu_torch.io.seqio import read_fasta_dict
from nanopore_tpu_torch.ops.dispatch import (
    PreparedRealign,
    local_dp_devices,
    preferred_realign_batch_size,
    prepared_from_pairs,
)
from nanopore_tpu_torch.ops.pack import MEA, check_band_width, padded_width
from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
from nanopore_tpu_torch.ops.posteriors import rescore_from_post
from nanopore_tpu_torch.ops.realign import DECODE, max_workspace_k
from nanopore_tpu_torch.runtime.prefetch import prefetched_map


def _next_pow2(x: int) -> int:
    return 1 << max(6, (x - 1).bit_length())


def window_global_pair(
    ref_codes: np.ndarray,
    cigar: list[tuple[int, int]],
    pad: int = 128,
) -> tuple[np.ndarray, list[tuple[int, int]], int, int]:
    """Trim a GLOBAL guide cigar to the read's aligned ref window.

    Chained records are global (pos 0, cigar spans the whole
    reference), so their leading/trailing pure-deletion runs are as
    long as the flanking reference — against a megabase contig that
    costs a megabase of DP diagonals per read for zero aligned-pair
    information.  This is the banded analogue of the reference's
    ``--splitMatrixBiggerThanThis`` matrix decomposition
    (utils.py:587): realign only ``ref[j0:j1]`` around the aligned
    span (± ``pad`` ref bases of slack for the redecode to move into)
    and splice the flanking deletions back afterwards
    (:func:`splice_window_cigar`).

    Returns ``(ref_window, window_guide, j0, j1)``; the window guide
    consumes ``j1 - j0`` reference and the full read.  When the guide
    has no flanking deletions beyond ``pad`` this is the identity
    (j0 = 0, j1 = n).
    """
    n = len(ref_codes)
    lead = 0
    i = 0
    while i < len(cigar) and cigar[i][0] in (_C.D, _C.N):
        lead += cigar[i][1]
        i += 1
    tail = 0
    j = len(cigar)
    while j > i and cigar[j - 1][0] in (_C.D, _C.N):
        tail += cigar[j - 1][1]
        j -= 1
    mid = list(cigar[i:j])
    if not mid:  # degenerate (no aligned read content): leave as-is
        return ref_codes, list(cigar), 0, n
    j0 = max(0, lead - pad)
    j1 = min(n, n - tail + pad)
    guide: list[tuple[int, int]] = []
    if lead - j0 > 0:
        guide.append((_C.D, lead - j0))
    guide += mid
    if j1 - (n - tail) > 0:
        guide.append((_C.D, j1 - (n - tail)))
    return ref_codes[j0:j1], guide, j0, j1


def split_window_pair(
    x: np.ndarray,
    y: np.ndarray,
    guide: list[tuple[int, int]],
    max_k: int,
    margin: int = 2048,
) -> list[tuple[int, int, int, int, list[tuple[int, int]]]]:
    """Split an over-budget window pair at CONFIDENT guide anchors.

    The reference bounds every realign DP with
    ``--splitMatrixBiggerThanThis=3000`` — cactus splits the matrix at
    confident aligned pairs into independently-processed blocks
    (reference nanopore/analyses/utils.py:587).  This is the banded
    equivalent for lattices whose diagonal count (n + m) exceeds what
    one read's forward-state workspace may hold
    (ops.realign.max_workspace_k).  Each cut is placed at the MIDPOINT
    of the longest guide M run inside the last part of the segment's
    cell budget — a confident anchor the realigned path almost surely
    passes through (a greedy cut wherever the budget fills can land in a
    noisy region and perturb aligned pairs) — so each segment is a
    self-contained global alignment over (x-slice, y-slice) and the
    segment cigars CONCATENATE into a cigar consuming the whole window.

    Returns ``[(j0, j1, i0, i1, guide_seg), ...]`` covering the window
    exactly; a single element = no split needed.
    """
    n, m = len(x), len(y)
    if n + m <= max_k:
        return [(0, n, 0, m, list(guide))]
    budget = max_k - min(margin, max_k // 8)
    if max_k > 2048:
        # segment k_max is rounded UP in 2048 steps downstream
        # (ops.dispatch._pairs_k_max); clamp the budget to a 2048
        # multiple so a rounded segment can never re-exceed max_k
        budget = min(budget, (max_k // 2048) * 2048)
    if budget <= 2:
        raise ValueError("split budget too small: max_k=%d" % max_k)

    # pass 1: pick cut CELL positions (cells = dx + dy consumed);
    # prefer the midpoint of the longest M run whose midpoint falls in
    # the last half of each segment's budget
    runs = []  # (op, length, cell0) with cell0 = cells consumed before
    cells = 0
    for op, length in guide:
        d = (1 if op in (_C.M, _C.D, _C.N) else 0) + (
            1 if op in (_C.M, _C.I) else 0
        )
        runs.append((op, length, cells, d))
        cells += d * length
    total = cells
    cuts: list[int] = []
    cur = 0
    while total - cur > budget:
        lo, hi = cur + budget // 2, cur + budget
        best = None  # (run_length, midpoint_cell)
        for op, length, cell0, d in runs:
            if op != _C.M or d != 2:
                continue
            end = cell0 + 2 * length
            if end <= lo or cell0 >= hi:
                continue
            mid = cell0 + 2 * (length // 2)
            mid = min(max(mid, lo), hi)
            # snap to an even offset within the run (a whole M step)
            mid = cell0 + 2 * max(1, min((mid - cell0) // 2, length - 1))
            if lo <= mid <= hi and (best is None or length > best[0]):
                best = (length, mid)
        cuts.append(best[1] if best else hi)
        cur = cuts[-1]

    # pass 2: materialise segments at the chosen cell positions
    segs: list[tuple[int, int, int, int, list]] = []
    j = i = 0
    cells = 0
    seg_j0, seg_i0 = 0, 0
    seg: list[tuple[int, int]] = []
    cut_iter = iter(cuts)
    next_cut = next(cut_iter, None)
    for op, length, cell0, d in runs:
        while length > 0:
            if next_cut is None or d == 0:
                step = length
            else:
                room = next_cut - cells
                if room <= 0:
                    step = length
                else:
                    step = min(length, max(1, room // d))
            seg.append((op, step))
            dx = 1 if op in (_C.M, _C.D, _C.N) else 0
            dy = 1 if op in (_C.M, _C.I) else 0
            j += dx * step
            i += dy * step
            cells += d * step
            length -= step
            if next_cut is not None and cells >= next_cut:
                segs.append((seg_j0, j, seg_i0, i, seg))
                seg_j0, seg_i0 = j, i
                seg = []
                next_cut = next(cut_iter, None)
    if seg or not segs:
        segs.append((seg_j0, j, seg_i0, i, seg))
    if j != n or i != m:
        raise ValueError("guide does not consume the window it splits")
    # drop empty trailing segments (possible when the guide ends on a
    # cut boundary)
    return [s for s in segs if s[4]]


def splice_window_cigar(
    cigar: list[tuple[int, int]], j0: int, j1: int, n: int
) -> list[tuple[int, int]]:
    """Re-embed a window-global cigar into full-reference coordinates:
    prepend/append the trimmed flanking deletions, merging runs."""
    out: list[tuple[int, int]] = []

    def push(op, length):
        if length <= 0:
            return
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + length)
        else:
            out.append((op, length))

    push(_C.D, j0)
    for op, length in cigar:
        push(op, length)
    push(_C.D, n - j1)
    return out


def realign_records(
    records: list[SamRecord],
    ref_seqs: dict[str, str],
    model: PairHmmModel | None = None,
    gap_gamma: float = 0.5,
    match_gamma: float = 0.0,
    band_width: int = 64,
    batch_size: int | None = None,
    rescore: bool = False,
    split_k: int | None = None,
    device=None,
) -> list[float]:
    """Redecode the cigars of chained global records in place.

    Records must satisfy the global-alignment invariant (pos == 0, cigar
    spans the whole reference and read — utils.py:491-501).  Windows
    whose diagonal count exceeds ``split_k`` are split at guide anchors
    (:func:`split_window_pair`); ``None`` means the largest count for
    which one read's workspace in the decode mode fits a launch
    (ops.realign.max_workspace_k of ``DECODE``).  Runs on the card unless
    ``device="cpu"``.  Returns the per-record average posterior match
    probability of the NEW alignment when ``rescore`` (the
    --rescoreByPosteriorProbIgnoringGaps analogue; records are not split
    then, as in the JAX package), else an empty list.  On the card the
    band width must be one the MEA path's kernels serve, 2 to 2048
    (ROADMAP C10, C11; above 1024 a read's band on a cluster of two
    blocks).
    """
    check_band_width(band_width, device, MEA)
    device = resolve_device(device)
    params = make_kernel_params(model or PairHmmModel.default())
    batch_size = preferred_realign_batch_size(batch_size, device)
    scores: list[float] = [float("nan")] * len(records)
    # the budget of the lanes the band is laid into (ops.pack.padded_width)
    split_budget = None if rescore else split_k or max_workspace_k(
        padded_width(band_width), DECODE)

    # window each global record to its aligned ref span (the banded
    # --splitMatrixBiggerThanThis analogue: flanking pure-D runs cost a
    # diagonal per ref base for zero aligned-pair information), then
    # bucket by padded WINDOW shapes so a batch's reads are of one size
    # class.  Windows over the split budget are split at guide anchors;
    # their segment cigars concatenate exactly.
    ref_codes = {name: encode(seq) for name, seq in ref_seqs.items()}
    # encoded reads, one encode per RECORD (split segments share it)
    enc_cache: dict[int, np.ndarray] = {}

    def enc_read(idx: int) -> np.ndarray:
        a = enc_cache.get(idx)
        if a is None:
            a = enc_cache[idx] = encode(records[idx].seq)
        return a

    windows: list[tuple[int, int, list]] = []
    # unit = (record idx, part idx, ref j0/j1 and read i0/i1 WINDOW-
    # relative, segment guide); single-part units are the common case
    units: list[tuple[int, int, int, int, int, int, list]] = []
    n_parts: list[int] = []
    for idx, rec in enumerate(records):
        if rec.pos != 0:
            raise ValueError("realign requires chained global records")
        _, guide, j0, j1 = window_global_pair(
            ref_codes[rec.rname], rec.cigar
        )
        windows.append((j0, j1, guide))
        m = len(rec.seq)
        if split_budget is not None and (j1 - j0) + m > split_budget:
            segs = split_window_pair(
                ref_codes[rec.rname][j0:j1], enc_read(idx), guide,
                split_budget,
            )
        else:
            segs = [(0, j1 - j0, 0, m, guide)]
        n_parts.append(len(segs))
        for part, (sj0, sj1, si0, si1, sg) in enumerate(segs):
            units.append((idx, part, sj0, sj1, si0, si1, sg))

    buckets: dict[tuple[int, int], list[int]] = {}
    for u, (idx, part, sj0, sj1, si0, si1, sg) in enumerate(units):
        buckets.setdefault(
            (_next_pow2(sj1 - sj0), _next_pow2(si1 - si0)), []
        ).append(u)

    # several local cards: each batch is packed onto and decoded on the
    # next one (count().__next__ is atomic on the worker threads)
    devices = local_dp_devices(device)
    batch_index = itertools.count()

    def batch_descriptors():
        for (n_pad, m_pad), idxs in buckets.items():
            for s in range(0, len(idxs), batch_size):
                yield idxs[s:s + batch_size], (n_pad, m_pad)

    def build(desc):
        """Pack, upload and launch, run on the prefetched_map worker
        pool: the host pack and the kernels of several batches overlap
        each other and the consumer."""
        sub, (n_pad, m_pad) = desc
        pairs = []
        for u in sub:
            idx, part, sj0, sj1, si0, si1, sg = units[u]
            rec = records[idx]
            j0, j1, _ = windows[idx]
            pairs.append((
                ref_codes[rec.rname][j0 + sj0:j0 + sj1],
                enc_read(idx)[si0:si1],
                sg,
            ))
        return sub, prepared_from_pairs(
            {
                "gap_gamma": gap_gamma,
                "match_gamma": match_gamma,
                "emit_gamma": rescore,
                "device": devices[next(batch_index) % len(devices)],
            },
            pairs,
            params,
            band_width=band_width,
            k_max=n_pad + m_pad,
            prepared_cls=PreparedRealign,
        ).launch()

    # multi-part records stitch once every part's cigar has decoded
    # (part cigars concatenate exactly — each cut is a lattice point
    # both segments pass through)
    pending: dict[int, list] = {}

    def finish(idx: int, part: int, cigar) -> None:
        j0, j1, _ = windows[idx]
        if n_parts[idx] == 1:
            records[idx].cigar = splice_window_cigar(
                cigar, j0, j1, len(ref_codes[records[idx].rname])
            )
            return
        parts = pending.setdefault(idx, [None] * n_parts[idx])
        parts[part] = cigar
        if any(c is None for c in parts):
            return
        full: list[tuple[int, int]] = []
        for c in parts:
            for op, length in c:
                if full and full[-1][0] == op:
                    full[-1] = (op, full[-1][1] + length)
                else:
                    full.append((op, length))
        records[idx].cigar = splice_window_cigar(
            full, j0, j1, len(ref_codes[records[idx].rname])
        )
        del pending[idx]

    for sub, prepared in prefetched_map(build, batch_descriptors(),
                                        depth=max(2, len(devices) + 1)):
        # the walk runs on the device; only op codes and logliks cross
        _, cigars, out = prepared.decode()
        if rescore:
            # the new window cigars over the same launch's gamma band;
            # only (B,) totals cross
            res = rescore_from_post(out, prepared.batch.offsets, cigars,
                                    band_width)
        for b, u in enumerate(sub):
            finish(units[u][0], units[u][1], cigars[b])
            if rescore:
                scores[units[u][0]] = res[b]
    if pending:
        raise RuntimeError("split parts left undecoded: %s" % sorted(pending))
    return scores if rescore else []


def realign_sam_file(
    sam_path: str,
    output_sam_path: str,
    read_fastq_path: str,
    reference_fasta_path: str,
    gap_gamma: float = 0.5,
    match_gamma: float = 0.0,
    hmm_model: PairHmmModel | None = None,
    band_width: int = 64,
    batch_size: int | None = None,
    shard: tuple[int, int] | None = None,
    device=None,
) -> None:
    """Chain then realign a SAM file (realignSamFileTargetFn semantics).

    ``shard=(i, n)``: chain deterministically (same result on every
    host), realign and write only every n-th chained record starting at
    i.  Runs on the card unless ``device="cpu"``; there the band width
    (2 to 2048) is checked before the SAM is chained (ROADMAP C10, C11).
    """
    check_band_width(band_width, device, MEA)
    with tempfile.TemporaryDirectory() as tmp:
        chained = os.path.join(tmp, "chained.sam")
        chain_sam_file(sam_path, chained, read_fastq_path, reference_fasta_path)
        reader = SamReader(chained)
        records = list(reader.mapped())
        if shard is not None:
            records = records[shard[0]::shard[1]]
        ref_seqs = read_fasta_dict(reference_fasta_path)
        realign_records(
            records, ref_seqs, hmm_model, gap_gamma, match_gamma,
            band_width, batch_size, device=device,
        )
        with SamWriter(output_sam_path, template=reader) as writer:
            for rec in records:
                writer.write(rec)
