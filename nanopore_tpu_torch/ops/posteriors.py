"""Consumers of the realign kernel's posterior outputs.

Counterpart of ``nanopore_tpu/ops/posteriors.py`` on the port's two
posterior outputs (``ops.realign``):

* rescore (``--rescoreByPosteriorProbIgnoringGaps``, AlignmentUncertainty
  and ``realign_records(rescore=True)``): the average gamma_match over a
  cigar's aligned pairs, a reduction over the (B, k_pad + 1, W) band on
  its device; only the (B,) totals reach the host;
* expectations (``--outputAllPosteriorProbs`` reduced to per-reference-
  position expected base counts, the SNP caller): the exp mode's retire
  stream and flush, rounded to f16 on the device before the pull (a
  count is a sum of at most W thresholded gammas, so f16's ~1e-3
  relative error is far below the caller's decision margins), then
  scattered into one (n, 4) matrix per read on the host.

The JAX package's other routes to the same expectations, the XLA retire
scan over a gamma band and its raw-layout twins, have no counterpart:
the fused route replaces them.
"""

from __future__ import annotations

import numpy as np
import torch

from nanopore_tpu_torch.io.sam import cigar_columns


def path_band_indices(
    cigar: list[tuple[int, int]],
    offsets: np.ndarray,
    band_width: int,
) -> tuple[np.ndarray, int]:
    """Band index of each aligned pair's lattice cell, per diagonal.

    Returns (pb (K+1,) int32 with -1 where the cigar has no aligned
    pair on that diagonal or the pair is off-band, count) where count
    is the TOTAL number of aligned pairs (off-band pairs contribute 0
    posterior but still count — rescore_by_posterior semantics).
    """
    offsets = np.asarray(offsets)
    pb = np.full(offsets.shape[0], -1, np.int32)
    on_read, on_ref = cigar_columns(cigar)
    match = on_read & on_ref
    jj = np.cumsum(on_ref)[match]  # the cell each aligned pair ends in
    kk = np.cumsum(on_read)[match] + jj
    bb = jj - offsets[kk]
    inb = (bb >= 0) & (bb < band_width)
    pb[kk[inb]] = bb[inb]
    return pb, int(match.sum())


def rescore_cigars(
    gm: torch.Tensor, offsets: np.ndarray,
    cigars: list[list[tuple[int, int]]], band_width: int,
) -> list[float]:
    """Average posterior match probability of each cigar's aligned
    pairs over the gamma_match band ``gm`` (B, K1, W) on its device.

    Each read's path cell of each diagonal is gathered from the band and
    summed on the device; only the (B,) totals cross to the host.  A
    cigar with no aligned pair scores NaN.
    """
    offsets = np.asarray(offsets)
    K1 = min(offsets.shape[1], gm.shape[1])
    pbs, counts = [], []
    for b, cig in enumerate(cigars):
        pb, count = path_band_indices(cig, offsets[b], band_width)
        pbs.append(pb[:K1])
        counts.append(count)
    pb = torch.from_numpy(np.stack(pbs).astype(np.int64)).to(gm.device)
    picked = torch.gather(gm[:, :K1], 2, pb.clamp(min=0)[:, :, None])[:, :, 0]
    totals = torch.where(pb >= 0, picked, 0.0).sum(dim=1).cpu().numpy()
    return [
        float(t) / c if c else float("nan")
        for t, c in zip(totals, counts)
    ]


def posterior_expectations_fused(
    ret: torch.Tensor, flush: torch.Tensor, offsets: np.ndarray,
    ns: np.ndarray, band_width: int,
) -> list[np.ndarray]:
    """Per-read (n, 4) expectation matrices from the exp mode's streams.

    ``ret`` (B, K1g, 4): row k holds the column retired on the k+1 -> k
    transition, reference position ``o[k+1] + W - 2``, valid where
    ``d1[k+1] = 1``; ``flush`` (B, 4, W): column w holds position
    ``w - 1``.  The retire rows cross to the host as f16 (rounded on
    their device), the flush as f32.
    """
    ret_h = ret.to(torch.float16).cpu().numpy().astype(np.float32)
    flush_h = flush.cpu().numpy()
    K1g = ret_h.shape[1]
    W = band_width
    offsets = np.asarray(offsets)
    out = []
    fpos = np.arange(W) - 1
    for b in range(len(ns)):
        n = int(ns[b])
        o = offsets[b]
        kmax = min(len(o) - 1, K1g - 1)
        d1 = o[1:kmax + 1] - o[:kmax]  # d1[k+1] at index k
        rows = np.nonzero(d1)[0]
        pos = o[rows + 1] + W - 2
        ok = (pos >= 0) & (pos < n)
        e = np.zeros((n, 4), np.float32)
        # each retired row / flush column is a distinct position (the
        # band retires each column exactly once): plain indexed adds
        e[pos[ok]] += ret_h[b, rows[ok]]
        fok = (fpos >= 0) & (fpos < n)
        e[fpos[fok]] += flush_h[b][:, fok].T
        out.append(e)
    return out


def rescore_from_post(post: dict, offsets, cigars, band_width: int):
    """Rescore ``cigars`` over a run output that holds a ``gamma`` band
    (``PreparedPosteriors(emit_gamma=True)`` or
    ``PreparedRealign(emit_gamma=True)``)."""
    if "gamma" not in post:
        raise ValueError("the run output holds no gamma band: launch with "
                         "emit_gamma=True")
    return rescore_cigars(post["gamma"], offsets, cigars, band_width)


def expectations_from_post(post: dict, offsets, ns, band_width: int):
    """Per-read expectation matrices over a
    ``PreparedPosteriors(emit_exp=True)`` run output (the threshold was
    applied in the kernel at launch)."""
    if "ret" not in post:
        raise ValueError("the run output holds no retire stream: launch "
                         "with emit_exp=True")
    return posterior_expectations_fused(
        post["ret"], post["flush"], offsets, ns, band_width
    )
