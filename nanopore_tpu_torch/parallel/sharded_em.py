"""Sharded Baum-Welch: EM over the (dp, trial) mesh of the process group.

Counterpart of ``nanopore_tpu/parallel/sharded_em.py``.  The reads are
split over ``dp`` in contiguous blocks; each rank packs and uploads its
block once (``align.em.prepare_batches``, round-robin over its local
cards) and runs the E-step on it, one launch of the realign kernel's EM
mode per batch, for each of its trials.  Its float64 expectation sums
all-reduce over its dp group (gloo, on the host), the M-step is host
arithmetic that every rank of the group repeats, and the trials, split
over ``trial``, are gathered back to every rank after each iteration.

The JAX package has two step builders (XLA, and the Pallas kernel under
``shard_map``) that pad the batch with zero-weight rows for their static
shapes; the port has one E-step and no padding: a rank that holds no
read joins every reduction with zeros.  As in ``align.em.em_train``, a
read whose expectations ``align.em.representable`` rejects is left out
of the counts, its flank correction too (the JAX package's sharded EM
has no such mask).  A read's E-step output does not depend on its batch
and the sums are float64, so the trained models equal the single-process
``em_train``'s up to the order of float64 additions.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from nanopore_tpu_torch.align.em import (
    _m_step,
    _sum_flank_corrections,
    check_kept,
    checkpoint_matches,
    expectation_sums,
    load_em_checkpoint,
    prepare_batches,
    save_em_checkpoint,
)
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.parallel.distributed import process_info
from nanopore_tpu_torch.parallel.mesh import DP_AXIS, TRIAL_AXIS, Mesh

# one row per trial: trans (25) | emis (80) | loglik | kept reads
_ROW = 25 + 80 + 2


def em_train_step(preps, models: list[PairHmmModel], mesh: Mesh, m_len,
                  n_len, device, pseudocount: float = 1e-6, correction=None,
                  total: int | None = None, iteration: int = 0,
                  trial_ids=None, stats=None) -> list[PairHmmModel]:
    """One EM iteration of ``models`` (this rank's trials) over the reads
    of ``preps`` (this rank's dp block).

    Each trial's E-step sums (``align.em.expectation_sums``: the kept
    reads' expectations plus ``correction``'s flank mass) all-reduce in
    float64 over the dp group with the count of kept reads, then every
    rank of the group takes the same M-step.  ``total`` is the read count
    over the whole dp axis (for the kept-read check).  Returns the new
    models, each with the iteration's log-likelihood.  Every rank of the
    dp group must call this with the same number of models.
    """
    rows = np.zeros((len(models), _ROW))
    for j, model in enumerate(models):
        trans, emis, loglik, kept = expectation_sums(
            preps, model, m_len, n_len, device, stats, correction
        )
        rows[j] = np.concatenate([trans.ravel(), emis.ravel(),
                                  [loglik, kept]])
    if mesh.dp_group is not None and len(models):
        summed = torch.from_numpy(rows)
        dist.all_reduce(summed, group=mesh.dp_group)
        rows = summed.numpy()
    out = []
    trial_ids = range(len(models)) if trial_ids is None else trial_ids
    for model, row, trial in zip(models, rows, trial_ids):
        loglik, kept = float(row[105]), int(round(row[106]))
        check_kept(kept, len(m_len) if total is None else total, loglik,
                   trial, iteration)
        t0 = time.perf_counter()
        new = _m_step(model, row[:25].reshape(5, 5),
                      row[25:105].reshape(5, 16), pseudocount)
        new.likelihood = loglik
        if stats is not None:
            stats.add("em_m_step", time.perf_counter() - t0)
        out.append(new)
    return out


def _gather_trials(mesh: Mesh, blocks, t, e, ll):
    """Every rank's (t, e, ll) rows of its trial block, gathered over the
    trial group into the full (T, ...) arrays on every rank.  Blocks may
    differ in size by one: each rank sends the largest block's rows."""
    if mesh.trial_group is None:
        return t, e, ll
    mine = blocks[mesh.coords[1]]
    size = max(len(b) for b in blocks)
    buf = torch.zeros((size, 25 + 80 + 1), dtype=torch.float64)
    for r, j in enumerate(mine):
        buf[r, :25] = torch.from_numpy(t[j].ravel())
        buf[r, 25:105] = torch.from_numpy(e[j].ravel())
        buf[r, 105] = ll[j]
    parts = [torch.empty_like(buf) for _ in blocks]
    dist.all_gather(parts, buf, group=mesh.trial_group)
    t, e, ll = t.copy(), e.copy(), ll.copy()
    for block, part in zip(blocks, parts):
        rows = part.numpy()
        for r, j in enumerate(block):
            t[j] = rows[r, :25].reshape(5, 5)
            e[j] = rows[r, 25:105].reshape(5, 16)
            ll[j] = rows[r, 105]
    return t, e, ll


def sharded_em_train(
    pairs,
    mesh: Mesh,
    trials: int = 3,
    iterations: int = 100,
    seed: int = 0,
    convergence_tol: float = 1e-4,
    band_width: int = 64,
    batch_size: int | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 10,
    fingerprint: dict | None = None,
    pseudocount: float = 1e-6,
    corr_pairs=(),
    window_pad: int | None = None,
    device=None,
    stats=None,
) -> tuple[PairHmmModel, list[PairHmmModel], list[list[float]]]:
    """Multi-trial EM over ``pairs`` (windowed (ref, read, guide), the
    same list on every rank) on ``mesh``.

    ``corr_pairs`` ((index into pairs, full reference, full guide)) are
    the windowed pairs whose flank mass ``align.flank`` restores at
    ``window_pad``; each rank adds those of its own reads.

    The trials' random starts are drawn from one ``default_rng(seed)`` in
    trial order, as the single-process path draws them.  The trials are
    split over the trial axis in contiguous blocks as ``np.array_split``
    splits them (the JAX package's Pallas route requires the trial count
    to divide the axis; here 3 trials on 2 ranks go 2 and 1) and advance
    together.  Convergence is tracked per trial: a trial's trace and
    final parameters freeze at its own convergence iteration, it is not
    stepped again, and the loop stops when every trial has converged.

    Checkpoints carry ``fingerprint`` (``em_fingerprint(...,
    sharded=True)``) and the JAX package's keys, so either package
    resumes the other's; only rank 0 writes and removes the file.

    Returns (best model, all per-trial models, per-trial running
    likelihoods), every rank the same.
    """
    dp, tr = mesh.shape[DP_AXIS], mesh.shape[TRIAL_AXIS]
    rank = process_info()[0]
    # dp block d holds pairs [bounds[d], bounds[d + 1]), as array_split
    bounds = np.cumsum([0] + [len(b) for b in np.array_split(
        np.arange(len(pairs)), dp)])
    lo, hi = int(bounds[mesh.coords[0]]), int(bounds[mesh.coords[0] + 1])
    mine = pairs[lo:hi]
    local_corr = [(i - lo, x, g) for i, x, g in corr_pairs if lo <= i < hi]
    correction = (_sum_flank_corrections(local_corr, window_pad)
                  if corr_pairs else None)
    n_len = np.array([len(x) for x, _, _ in mine], np.float64)
    m_len = np.array([len(y) for _, y, _ in mine], np.float64)
    preps = prepare_batches(mine, band_width, batch_size, device)
    blocks = [b.tolist() for b in np.array_split(np.arange(trials), tr)]
    block = blocks[mesh.coords[1]]

    rng = np.random.default_rng(seed)
    models = [PairHmmModel.random(rng) for _ in range(trials)]
    t = np.stack([mm.transitions for mm in models]).astype(np.float64)
    e = np.stack([mm.emissions for mm in models]).astype(np.float64)
    traces: list[list[float]] = [[] for _ in range(trials)]
    prev = np.full(trials, np.nan)
    converged = np.zeros(trials, bool)
    final_t, final_e = t.copy(), e.copy()
    start_iter = 0
    ck = load_em_checkpoint(checkpoint_path) if checkpoint_path else None
    if fingerprint is not None:
        if not checkpoint_matches(ck, fingerprint):
            ck = None
    elif ck is not None and (
        ck.get("format") != "sharded" or int(ck.get("trials", -1)) != trials
    ):
        ck = None
    if ck is not None:
        start_iter = int(ck["iteration"])
        t = np.asarray(ck["t"], np.float64)
        e = np.asarray(ck["e"], np.float64)
        traces = [list(trace) for trace in ck["traces"]]
        prev = np.asarray(ck["prev_ll_per_trial"], np.float64)
        converged = np.asarray(ck["converged"], bool).copy()
        final_t = np.asarray(ck["final_t"], np.float64).copy()
        final_e = np.asarray(ck["final_e"], np.float64).copy()
    for it in range(start_iter, iterations):
        # every rank of a dp group holds the same block and the same
        # convergence flags, so they step the same trials
        active = [j for j in block if not converged[j]]
        stepped = em_train_step(
            preps,
            [PairHmmModel(transitions=t[j], emissions=e[j]) for j in active],
            mesh, m_len, n_len, device, pseudocount, correction,
            total=len(pairs), iteration=it, trial_ids=active, stats=stats,
        )
        t, e, ll = t.copy(), e.copy(), np.full(trials, np.nan)
        for j, mm in zip(active, stepped):
            t[j], e[j], ll[j] = mm.transitions, mm.emissions, mm.likelihood
        t, e, ll = _gather_trials(mesh, blocks, t, e, ll)
        for j in range(trials):
            if not converged[j]:
                traces[j].append(float(ll[j]))
        newly = (
            (~converged)
            & ~np.isnan(prev)
            & (np.abs(ll - prev) <= convergence_tol * np.abs(prev))
        )
        for j in np.nonzero(newly)[0]:
            final_t[j] = t[j]
            final_e[j] = e[j]
            converged[j] = True
        prev = np.where(converged, prev, ll)
        if converged.all():
            break
        if (checkpoint_path and (it + 1) % checkpoint_every == 0
                and rank == 0):
            save_em_checkpoint(
                checkpoint_path,
                {
                    **(fingerprint or {"format": "sharded",
                                       "trials": trials}),
                    "iteration": it + 1,
                    "t": t,
                    "e": e,
                    "traces": traces,
                    "prev_ll_per_trial": prev,
                    "converged": converged,
                    "final_t": final_t,
                    "final_e": final_e,
                },
            )
    for j in range(trials):
        if not converged[j]:
            final_t[j] = t[j]
            final_e[j] = e[j]
    if checkpoint_path and rank == 0 and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)
    trial_models = [
        PairHmmModel(
            transitions=final_t[j],
            emissions=final_e[j],
            likelihood=traces[j][-1] if traces[j] else 0.0,
        )
        for j in range(trials)
    ]
    best = (
        int(np.argmax([mm.likelihood for mm in trial_models]))
        if any(traces)
        else 0
    )
    return trial_models[best], trial_models, traces
