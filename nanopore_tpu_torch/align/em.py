"""Baum-Welch EM training of the pair-HMM on one device.

Counterpart of ``nanopore_tpu/align/em.py`` (its single-device branch).
Replaces ``cactus_expectationMaximisation.expectationMaximisationTrials``
as driven by the reference at reference nanopore/analyses/utils.py:471-538:
multi-trial random-restart Baum-Welch where each iteration's E-step is
the banded forward/backward over every (read, ref) global alignment —
the hottest loop of the whole reference system.  Here the E-step is one
launch of the fused realign kernel's EM mode per batch
(``ops.dispatch.PreparedEm``): the packed codes stay on the device for
the whole training and only the model tables change between iterations.
The per-read expectation tensors are summed on the host in float64 and
the M-step is host arithmetic.

Reference option parity (utils.py:509-523): fiveStateAsymmetric model,
randomStart, trials=3, iterations=100, maxAlignmentLengthToSample=5e7,
trainEmissions; post-processing flattens indel emissions and renormalises
match emissions to GC 0.5 (utils.py:531-538).

``use_mesh=True`` trains over the (dp, trial) mesh of the process group
(``parallel/sharded_em.py``): each rank runs the E-step of its reads on
its own card(s), and the float64 sums all-reduce over gloo.
"""

from __future__ import annotations

import json
import logging
import os
import time
import zipfile
import zlib
from dataclasses import dataclass, replace

import numpy as np
import torch

from nanopore_tpu_torch.align.flank import corridor_tables, em_flank_correction
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.align.realign import window_global_pair
from nanopore_tpu_torch.device import resolve_device
from nanopore_tpu_torch.io.encoding import encode
from nanopore_tpu_torch.io.sam import SamReader
from nanopore_tpu_torch.io.seqio import read_fasta_dict
from nanopore_tpu_torch.ops.dispatch import (
    PreparedEm,
    local_dp_devices,
    preferred_realign_batch_size,
    prepared_from_pairs,
)
from nanopore_tpu_torch.ops.pack import MEA, check_band_width
from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
from nanopore_tpu_torch.parallel.distributed import process_info

logger = logging.getLogger("nanopore_tpu_torch")


@dataclass
class EmOptions:
    trials: int = 3
    iterations: int = 100
    max_sample_bases: int = 50_000_000  # maxAlignmentLengthToSample
    band_width: int = 64
    # reads per E-step launch; None: ops.dispatch picks for the device
    # (the kernel runs one warp per read, so the card wants hundreds).
    # Per-read outputs do not depend on the batch and the host sums them
    # in float64, so the trained model does not depend on it either.
    batch_size: int | None = None
    seed: int = 0
    pseudocount: float = 1e-6
    convergence_tol: float = 1e-4  # relative loglik change to stop early
    # train over the (dp, trial) mesh of the process group
    # (parallel/sharded_em): None = exactly when the group has more than
    # one rank.  A single process with several local cards instead
    # round-robins its batches over them (ops.dispatch.local_dp_devices).
    use_mesh: bool | None = None
    # EM window pad (ref bases kept around each aligned span).  Chained
    # global records span the WHOLE reference (utils.py:491-501); on a
    # megabase contig the flanking pure-deletion runs would cost a DP
    # diagonal per ref base per read per iteration.  The lattice is
    # windowed (align.realign.window_global_pair) and the flank mass —
    # which the reference's EM counts, notably the D->D dwell
    # transitions — is restored analytically per iteration
    # (align.flank.em_flank_correction): the banded analogue of
    # --splitMatrixBiggerThanThis=300 (utils.py:511).  None disables
    # windowing (full-reference lattices).
    window_pad: int | None = 256
    # mid-training checkpoint/resume: HMM params + trial/iteration
    # indices + traces saved every `checkpoint_every` iterations; a
    # restarted run resumes from the file instead of retraining (the
    # reference only resumes at whole-model granularity,
    # utils.py:527-528)
    checkpoint_path: str | None = None
    checkpoint_every: int = 10


@dataclass
class EmResult:
    model: PairHmmModel  # best trial, unnormalised
    trial_models: list[PairHmmModel]
    running_likelihoods: list[list[float]]


def save_em_checkpoint(path: str, state: dict) -> None:
    """Atomically persist EM training state (arrays + JSON metadata)."""
    arrays = {k: v for k, v in state.items() if isinstance(v, np.ndarray)}
    meta = {k: v for k, v in state.items() if not isinstance(v, np.ndarray)}
    # pid-suffixed tmp name: two runs sharing an output path must not
    # interleave writes into the same tmp file
    tmp = "%s.%d.tmp" % (path, os.getpid())
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def em_fingerprint(pairs, opts: EmOptions, sharded: bool = False) -> dict:
    """Config+data fingerprint stored in checkpoints: a resume is only
    valid when it was written by a run with identical inputs (resuming
    across a changed SAM, seed or band would silently produce a model
    trained on the old configuration).  The same keys and values as the
    JAX package's, so either package resumes the other's checkpoint;
    ``sharded`` marks the mesh run's format."""
    crc = 0
    for x, y, _ in pairs:
        crc = zlib.crc32(np.ascontiguousarray(x[:128]).tobytes(), crc)
        crc = zlib.crc32(np.ascontiguousarray(y[:128]).tobytes(), crc)
        crc = zlib.crc32(
            np.array([len(x), len(y)], np.int64).tobytes(), crc
        )
    return {
        "format": "sharded" if sharded else "per_trial",
        "trials": opts.trials,
        "iterations": opts.iterations,
        "seed": opts.seed,
        "band_width": opts.band_width,
        "pseudocount": opts.pseudocount,
        "window_pad": opts.window_pad,
        "n_pairs": len(pairs),
        "data_crc": crc,
    }


def checkpoint_matches(ck: dict | None, fp: dict) -> bool:
    """True when a loaded checkpoint carries exactly fingerprint fp."""
    if ck is None:
        return False
    if any(ck.get(k) != v for k, v in fp.items()):
        logger.warning(
            "EM checkpoint fingerprint mismatch (stale config/data); "
            "ignoring checkpoint and retraining from scratch"
        )
        return False
    return True


def load_em_checkpoint(path: str) -> dict | None:
    """Load an EM checkpoint written by save_em_checkpoint, or None."""
    if not path or not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as npz:
            state = {
                k: np.asarray(npz[k]) for k in npz.files if k != "__meta__"
            }
            state.update(json.loads(str(npz["__meta__"])))
        return state
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None  # corrupt/partial checkpoint: retrain from scratch


def _m_step(
    model: PairHmmModel,
    trans: np.ndarray,
    emis: np.ndarray,
    pseudocount: float,
) -> PairHmmModel:
    structure = (model.transitions > 0).astype(np.float64)
    t = trans * structure + pseudocount * structure
    t = t / np.maximum(t.sum(axis=1, keepdims=True), 1e-30)
    e = emis + pseudocount
    e = e / np.maximum(e.sum(axis=1, keepdims=True), 1e-30)
    return PairHmmModel(
        transitions=t,
        emissions=e,
        likelihood=model.likelihood,
        model_type=model.model_type,
    )


def _e_step(preps: list[PreparedEm], params, device, stats):
    """Launch every batch's E-step and bring the per-read expectations
    to the host in float64: (trans (N,5,5), emis (N,5,16), loglik (N,)).
    On several cards the CUDA events time the first card's stream."""
    if not preps:  # a rank that holds no read
        return np.zeros((0, 5, 5)), np.zeros((0, 5, 16)), np.zeros(0)
    on_card = device.type == "cuda"
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    outs = [prep.run(params) for prep in preps]
    if on_card:
        end.record()
    # the copies to the host synchronise with the launches
    trans, emis, loglik = (
        np.concatenate([out[key].cpu().numpy().astype(np.float64)
                        for out in outs])
        for key in ("trans", "emis", "loglik")
    )
    if stats is not None:
        stats.add("em_e_step", time.perf_counter() - t0)
        if on_card:
            stats.add("em_e_step_device", start.elapsed_time(end) / 1e3)
    return trans, emis, loglik


def representable(trans: np.ndarray, emis: np.ndarray, m: np.ndarray,
                  n: np.ndarray) -> np.ndarray:
    """(N,) bool: whose expectations the scaled f32 recursion could hold.

    Every path of a read's banded lattice consumes its n window bases and
    its m read bases, so the expected transitions into the match and
    delete states sum to n and those into the match and insert states to
    m, here to 1 % (f32 rounding stays orders below; sums that left the
    range miss by orders).  The forward and the backward are each scaled
    by their own band maximum; where the two maxima sit at opposite band
    edges over thousands of diagonals (a long pure-deletion run followed
    by read bases: the window of a chained record that ends
    ``<tail>D <k>I`` reaches the end of the reference) their product leaves the f32 range,
    the posterior factor saturates, and the sums come out non-finite or
    orders of magnitude off.  The log-likelihood comes from the forward
    alone and stays right.
    """
    flat = np.concatenate([trans.reshape(-1, 25), emis.reshape(-1, 80)],
                          axis=1)
    finite = np.isfinite(flat).all(axis=1)
    into = np.where(finite[:, None], trans.sum(axis=1), 0.0)  # (N, 5)
    ref_used = into[:, 0] + into[:, 1] + into[:, 3]
    read_used = into[:, 0] + into[:, 2] + into[:, 4]
    return (finite & (np.abs(ref_used - n) <= 1e-2 * np.maximum(n, 1))
            & (np.abs(read_used - m) <= 1e-2 * np.maximum(m, 1)))


def prepare_batches(pairs, band_width: int, batch_size: int | None,
                    device) -> list[PreparedEm]:
    """Pack and upload the E-step's batches once for the whole training
    (they are shape-stable across iterations).  With several local cards
    the batches round-robin over them (``ops.dispatch.local_dp_devices``);
    the host still sums their outputs in batch order, so the model does
    not depend on the count of cards."""
    devices = local_dp_devices(device)
    batch_size = preferred_realign_batch_size(batch_size, device)
    return [
        prepared_from_pairs(
            {"device": devices[i % len(devices)]}, pairs[s:s + batch_size],
            None, band_width=band_width, prepared_cls=PreparedEm,
        )
        for i, s in enumerate(range(0, len(pairs), batch_size))
    ]


def _sum_flank_corrections(corr_pairs, window_pad: int):
    """The summed analytic flank mass (align.flank) of windowed pairs:
    a callable ``(model, ok) -> (ct (5,5), ce (5,16), cll)`` over
    ``corr_pairs`` ((index of the read in ``ok``, full reference, full
    guide)).  A pair whose read ``ok`` leaves out of the counts adds its
    log-likelihood only."""

    def correction(model, ok):
        t_c, eg_c = corridor_tables(model)
        ct, ce, cll = np.zeros((5, 5)), np.zeros((5, 16)), 0.0
        for i, x_full, guide_full in corr_pairs:
            dt, de, dll = em_flank_correction(
                x_full, guide_full, window_pad, t_c, eg_c
            )
            if ok[i]:
                ct += dt
                ce += de
            cll += dll
        return ct, ce, cll

    return correction


def expectation_sums(preps, model: PairHmmModel, m_len, n_len, device,
                     stats=None, correction=None):
    """One E-step under ``model`` over the reads of ``preps`` (read
    lengths ``m_len``, window lengths ``n_len``): the float64 sums of the
    expectations of the reads :func:`representable` keeps, plus
    ``correction(model, ok)``'s flank mass.  Returns (trans (5,5), emis
    (5,16), loglik, kept reads); every read's log-likelihood counts."""
    trans_r, emis_r, loglik_r = _e_step(
        preps, make_kernel_params(model), device, stats
    )
    ok = representable(trans_r, emis_r, m_len, n_len)
    if stats is not None:
        for _ in range(int((~ok).sum())):
            stats.add("em_left_out", 0.0)
    trans = trans_r[ok].sum(axis=0)
    emis = emis_r[ok].sum(axis=0)
    loglik = float(loglik_r.sum())
    if correction is not None:
        t0 = time.perf_counter()
        ct, ce, cll = correction(model, ok)
        trans += ct
        emis += ce
        loglik += cll
        if stats is not None:
            stats.add("em_flank", time.perf_counter() - t0)
    return trans, emis, loglik, int(ok.sum())


def check_kept(kept: int, total: int, loglik: float, trial: int,
               iteration: int) -> None:
    """Raise when an iteration kept no read (or its likelihood is not
    finite); warn when it left some out."""
    if not kept or not np.isfinite(loglik):
        raise FloatingPointError(
            "the E-step gave no usable expectations (loglik %r, %d of %d "
            "reads representable)" % (loglik, kept, total)
        )
    if kept < total:
        logger.warning(
            "EM trial %d iteration %d: %d of %d reads left out of the "
            "counts (expectations outside the f32 range)",
            trial, iteration, total - kept, total,
        )


def em_train(
    pairs: list[tuple[np.ndarray, np.ndarray, list[tuple[int, int]]]],
    options: EmOptions | None = None,
    device=None,
    stats=None,
) -> EmResult:
    """Multi-trial Baum-Welch over (ref_codes, read_codes, guide) pairs.

    Runs on the card unless ``device="cpu"``.  ``stats`` (a
    ``mapping.engine.StageStats``) collects the seconds of the E-step
    (``em_e_step``, and ``em_e_step_device`` from CUDA events on a
    card), the host flank correction (``em_flank``) and the M-step
    (``em_m_step``), one call per iteration.

    ``options.use_mesh`` (None: exactly when the process group has more
    than one rank; the JAX package's None means several TPU chips) trains
    over the (dp, trial) mesh of the process group
    (``parallel/sharded_em.py``); every rank must call this with the same
    pairs.  Without it the trials run one after another on ``device``,
    whose batches round-robin over the local cards when there are several
    (the JAX package's single path does the same).

    A read whose expectations :func:`representable` rejects under the
    current model is left out of that iteration's counts (its flank
    correction too) and is counted once in ``stats`` under
    ``em_left_out``; its log-likelihood still enters the running
    likelihood.  The JAX package has no such check: there the sums of
    such a read collapse (XLA scan) and enter the M-step as they are.
    An iteration that keeps no read raises ``FloatingPointError``.
    """
    opts = options or EmOptions()
    check_band_width(opts.band_width, device, MEA)
    device = resolve_device(device)
    rng = np.random.default_rng(opts.seed)

    # sampling cap (maxAlignmentLengthToSample, utils.py:517)
    kept, total = [], 0
    for pair in pairs:
        total += len(pair[1])
        if total > opts.max_sample_bases:
            break
        kept.append(pair)
    if not kept:
        raise ValueError("no alignments to train on")

    # window each global pair to its aligned ref span; flank mass is
    # restored analytically per iteration (EmOptions.window_pad).  The
    # fingerprint covers the ORIGINAL pairs (resume safety).
    fingerprint_pairs = kept
    corr_pairs: list = []  # (index into kept, full reference, guide)
    if opts.window_pad is not None:
        windowed = []
        for i, (x, y, guide) in enumerate(kept):
            xw, gw, g0, g1 = window_global_pair(x, guide, pad=opts.window_pad)
            windowed.append((xw, y, gw))
            if g0 > 0 or g1 < len(x):
                corr_pairs.append((i, x, guide))
        kept = windowed
    use_mesh = opts.use_mesh
    if use_mesh is None:
        use_mesh = process_info()[1] > 1
    if use_mesh:
        return _em_train_sharded(kept, opts, corr_pairs, fingerprint_pairs,
                                 device, stats)
    fingerprint = em_fingerprint(fingerprint_pairs, opts)
    correction = (_sum_flank_corrections(corr_pairs, opts.window_pad)
                  if corr_pairs else None)
    n_len = np.array([len(x) for x, _, _ in kept], np.float64)
    m_len = np.array([len(y) for _, y, _ in kept], np.float64)
    preps = prepare_batches(kept, opts.band_width, opts.batch_size, device)

    trial_models: list[PairHmmModel] = []
    running: list[list[float]] = []
    ck = (
        load_em_checkpoint(opts.checkpoint_path)
        if opts.checkpoint_path
        else None
    )
    if not checkpoint_matches(ck, fingerprint):
        ck = None
    start_trial, start_iter = 0, 0
    resumed_model = None
    resumed_trace: list[float] = []
    resumed_prev = None
    if ck is not None:
        start_trial = int(ck["trial"])
        start_iter = int(ck["iteration"])
        # one PairHmmModel.random draw per STARTED trial keeps the rng
        # stream identical to an uninterrupted run (iteration 0 means the
        # trial has not drawn its random init yet)
        for _ in range(start_trial + (1 if start_iter > 0 else 0)):
            PairHmmModel.random(rng)
        for d in range(start_trial):
            trial_models.append(PairHmmModel(
                transitions=np.asarray(ck["done_t"][d], np.float64),
                emissions=np.asarray(ck["done_e"][d], np.float64),
                likelihood=float(ck["done_ll"][d]),
            ))
            running.append(list(ck["traces"][d]))
        if start_iter > 0:
            resumed_model = PairHmmModel(
                transitions=np.asarray(ck["t"], np.float64),
                emissions=np.asarray(ck["e"], np.float64),
                likelihood=float(ck["likelihood"]),
            )
            resumed_trace = list(ck["traces"][start_trial])
            resumed_prev = ck["prev_ll"]

    def _dump(trial, iteration, model, trace, prev_ll):
        if not opts.checkpoint_path:
            return
        save_em_checkpoint(
            opts.checkpoint_path,
            {
                **fingerprint,
                "trial": trial,
                "iteration": iteration,
                "t": np.asarray(model.transitions, np.float64),
                "e": np.asarray(model.emissions, np.float64),
                "likelihood": float(model.likelihood or 0.0),
                "prev_ll": prev_ll,
                "done_t": np.stack(
                    [mm.transitions for mm in trial_models]
                )
                if trial_models
                else np.zeros((0, 5, 5)),
                "done_e": np.stack([mm.emissions for mm in trial_models])
                if trial_models
                else np.zeros((0, 5, 16)),
                "done_ll": [float(mm.likelihood) for mm in trial_models],
                "traces": running + [trace],
            },
        )

    for trial in range(start_trial, opts.trials):
        if trial == start_trial and resumed_model is not None:
            model = resumed_model
            trace = resumed_trace
            prev_ll = resumed_prev
            it0 = start_iter
        else:
            model = PairHmmModel.random(rng)
            trace = []
            prev_ll = None
            it0 = 0
        for it in range(it0, opts.iterations):
            trans, emis, loglik, n_kept = expectation_sums(
                preps, model, m_len, n_len, device, stats, correction
            )
            check_kept(n_kept, len(kept), loglik, trial, it)
            trace.append(loglik)
            t0 = time.perf_counter()
            model = _m_step(model, trans, emis, opts.pseudocount)
            model.likelihood = loglik
            if stats is not None:
                stats.add("em_m_step", time.perf_counter() - t0)
            if prev_ll is not None and abs(loglik - prev_ll) <= (
                opts.convergence_tol * abs(prev_ll)
            ):
                break
            prev_ll = loglik
            if (it + 1) % opts.checkpoint_every == 0:
                _dump(trial, it + 1, model, trace, prev_ll)
        trial_models.append(model)
        running.append(trace)
        if trial + 1 < opts.trials:
            _dump(trial + 1, 0, model, [], None)
    if opts.checkpoint_path and os.path.exists(opts.checkpoint_path):
        os.remove(opts.checkpoint_path)  # training complete

    best = max(trial_models, key=lambda mm: mm.likelihood)
    return EmResult(
        model=best, trial_models=trial_models, running_likelihoods=running
    )


def _em_train_sharded(kept, opts: EmOptions, corr_pairs, fingerprint_pairs,
                      device, stats) -> EmResult:
    """Mesh-sharded EM (``parallel/sharded_em``): reads over dp, trials
    over the trial axis of the process group's mesh."""
    from nanopore_tpu_torch.parallel.mesh import make_mesh
    from nanopore_tpu_torch.parallel.sharded_em import sharded_em_train

    model, trial_models, traces = sharded_em_train(
        kept,
        make_mesh(n_trials=opts.trials),
        trials=opts.trials,
        iterations=opts.iterations,
        seed=opts.seed,
        convergence_tol=opts.convergence_tol,
        band_width=opts.band_width,
        batch_size=opts.batch_size,
        checkpoint_path=opts.checkpoint_path,
        checkpoint_every=opts.checkpoint_every,
        fingerprint=em_fingerprint(fingerprint_pairs, opts, sharded=True),
        pseudocount=opts.pseudocount,
        corr_pairs=corr_pairs,
        window_pad=opts.window_pad,
        device=device,
        stats=stats,
    )
    return EmResult(
        model=model, trial_models=trial_models, running_likelihoods=traces
    )


def learn_model_from_sam_file(
    sam_path: str,
    reference_fasta_path: str,
    output_model_path: str,
    options: EmOptions | None = None,
    device=None,
    stats=None,
    write_files: bool = True,
) -> PairHmmModel:
    """EM on a chained SAM; write hmm.txt, hmm.txt_unnormalised and
    hmm.txt.xml (only with ``write_files``: over a mesh every rank
    computes the same model and the coordinator owns the files).

    Semantics of learnModelFromSamFileTargetFn (+2) (utils.py:471-538):
    train on the global alignments (in alignment orientation — the
    reference feeds reverse-complemented reads under ``_reverse`` names,
    utils.py:482-499, which is exactly the record's stored seq), pick the
    best of the random-restart trials, then flatten indel emissions and
    renormalise match emissions to 50% GC.  The XML flavour carries the
    across-trial avg/std and per-trial running likelihoods consumed by
    the Hmm analysis (reference analyses/hmm.py:31-47,82-84).
    """
    ref_seqs = read_fasta_dict(reference_fasta_path)
    ref_codes = {name: encode(seq) for name, seq in ref_seqs.items()}
    pairs = []
    for rec in SamReader(sam_path).mapped():
        if rec.pos != 0:
            raise ValueError("EM requires chained global records")
        pairs.append((ref_codes[rec.rname], encode(rec.seq), rec.cigar))
    options = options or EmOptions()
    if options.checkpoint_path is None:
        # mid-training resume by default: a killed/restarted pipeline
        # picks EM up at the last checkpointed (trial, iteration) instead
        # of retraining (file removed on completion)
        options = replace(
            options, checkpoint_path=output_model_path + ".ckpt.npz"
        )
    result = em_train(pairs, options, device=device, stats=stats)

    unnormalised = result.model
    if write_files:
        unnormalised.write(output_model_path + "_unnormalised")

    final = PairHmmModel(
        transitions=unnormalised.transitions.copy(),
        emissions=unnormalised.emissions.copy(),
        likelihood=unnormalised.likelihood,
        model_type=unnormalised.model_type,
    )
    final.set_indel_emissions_flat()
    final.normalise_by_reference_gc_content(0.5)
    if not write_files:
        return final
    final.write(output_model_path)

    t_stack = np.stack([m.transitions for m in result.trial_models])
    e_stack = np.stack([m.emissions for m in result.trial_models])
    xml_model = PairHmmModel(
        transitions=t_stack.mean(axis=0),
        emissions=e_stack.mean(axis=0),
        likelihood=unnormalised.likelihood,
        model_type=unnormalised.model_type,
        running_likelihoods=result.running_likelihoods,
    )
    xml_model.write_xml(
        output_model_path + ".xml",
        transitions_std=t_stack.std(axis=0),
        emissions_std=e_stack.std(axis=0),
    )
    return final
