"""MarginAlign SNP caller: margin-over-alignments variant calling study.

Counterpart of ``nanopore_tpu/analyses/snp_caller.py``, reproducing the
reference MarginAlignSnpCaller
(reference nanopore/analyses/marginAlignSnpCaller.py): for each HMM
type x coverage quota x replicate, sample reads, accumulate per-
reference-position posterior base expectations (the reference execs
``cactus_realign --outputAllPosteriorProbs`` per read,
marginAlignSnpCaller.py:136-146) and plain aligned-base frequencies,
call bases with a log-space Bayesian posterior over evolutionary x error
substitution matrices (calcBasePosteriorProbs, :18-23), score against
the held-out SNP truth from the mutated-reference index, and emit
precision/recall/F-by-threshold XML.

Posteriors are computed ONCE per HMM type for all records (they do not
depend on the sampling quota), and the per-position Bayesian calls are
vectorised over the whole reference; sampling replicates then only
re-select read subsets.  Each batch of windows goes through one launch
of the realign kernel's exp mode (``PreparedPosteriors(emit_exp=True)``),
which bins the thresholded gamma_match by read base inside its backward
sweep and retires one reference column per band shift; only that retire
stream (as f16) and the (4, W) flush cross to the host, where they are
scattered into per-record (refLen, 4) matrices.  Runs on the card unless
the analysis was given ``device="cpu"``.  Randomised read order uses a
seeded generator for reproducibility (the reference's unseeded
random.shuffle is the only divergence).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.align.realign import (
    _next_pow2,
    split_window_pair,
    window_global_pair,
)
from nanopore_tpu_torch.analyses.alignment_uncertainty import trained_hmm_path
from nanopore_tpu_torch.analyses.base import Analysis
from nanopore_tpu_torch.analyses.common import ExperimentData
from nanopore_tpu_torch.device import resolve_device
from nanopore_tpu_torch.io.encoding import encode
from nanopore_tpu_torch.io.sam import CIG
from nanopore_tpu_torch.io.seqio import read_fasta_dict
from nanopore_tpu_torch.io.xmlio import pretty_xml
from nanopore_tpu_torch.ops.dispatch import (
    PreparedPosteriors,
    preferred_realign_batch_size,
    prepared_from_pairs,
)
from nanopore_tpu_torch.ops.pack import padded_width
from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
from nanopore_tpu_torch.ops.posteriors import expectations_from_post
from nanopore_tpu_torch.ops.realign import max_workspace_k
from nanopore_tpu_torch.runtime.prefetch import prefetched_map


BASES = "ACGT"

HMM_TYPES = ("cactus", "trained_0", "trained_20", "trained_40")
COVERAGES = (1000000, 120, 60, 30, 10)
POSTERIOR_THRESHOLD = 1e-3  # matches cactus_realign's output sparsity


def get_null_substitution_matrix() -> np.ndarray:
    """(4,4) of ones (marginAlignSnpCaller.py:31-32)."""
    return np.ones((4, 4))


def get_jukes_cantor_matrix() -> np.ndarray:
    """0.8 diagonal / 0.2-over-3 off-diagonal (:34-35)."""
    m = np.full((4, 4), 0.2 / 3)
    np.fill_diagonal(m, 0.8)
    return m


def calc_base_posterior_probs(
    obs_frac: np.ndarray,  # (P, 4) normalised base observations
    ref_base_codes: np.ndarray,  # (P,) mutated ref base codes (0-3)
    evo: np.ndarray,  # (4, 4) evolutionary substitution matrix
    err: np.ndarray,  # (4, 4) error substitution matrix
) -> np.ndarray:
    """Vectorised calcBasePosteriorProbs (:18-23). Returns (P, 4)."""
    log_evo = np.log(evo)  # [refBase, missing]
    log_err = np.log(err)  # [missing, observed]
    logp = log_evo[ref_base_codes] + obs_frac @ log_err.T
    logp -= logp.max(axis=1, keepdims=True)
    p = np.exp(logp)
    return p / p.sum(axis=1, keepdims=True)


def _bucket_cumulative(probs: np.ndarray) -> np.ndarray:
    """Cumulative >=threshold counts over 101 probability buckets
    (SnpCalls.bucket, :171-180)."""
    buckets = np.zeros(101)
    if len(probs):
        idx = np.clip(np.round(probs * 100).astype(int), 0, 100)
        np.add.at(buckets, idx, 1)
    return buckets[::-1].cumsum()[::-1]


class _SnpCalls:
    def __init__(self, total_held_out: int):
        self.tp_probs: list[float] = []
        self.fp_probs: list[float] = []
        self.not_called = 0
        self.total_held_out = total_held_out

    def precision_by_probability(self) -> np.ndarray:
        tps = _bucket_cumulative(np.array(self.tp_probs))
        fps = _bucket_cumulative(np.array(self.fp_probs))
        denom = tps + fps
        return np.where(denom > 0, tps / np.maximum(denom, 1), 0.0)

    def recall_by_probability(self) -> np.ndarray:
        tps = _bucket_cumulative(np.array(self.tp_probs))
        if self.total_held_out == 0:
            return np.zeros_like(tps)
        return tps / self.total_held_out


class MarginAlignSnpCaller(Analysis):
    """``split_k``: windows whose diagonal count exceeds it are split at
    guide anchors (``align.realign.split_window_pair``); ``None`` means
    the largest count for which one read's forward-state workspace fits
    a launch (``ops.realign.max_workspace_k``)."""

    band_width = 64
    batch_size = None  # ops.dispatch picks (512 on the card)
    seed = 1234

    def __init__(self, read_fastq_file: str, read_type: str,
                 reference_fasta_file: str, sam_file: str, output_dir: str,
                 device=None, split_k: int | None = None):
        super().__init__(read_fastq_file, read_type, reference_fasta_file,
                         sam_file, output_dir, device)
        self.split_k = split_k

    # ------------------------------------------------------------------ #
    def _posteriors_for_hmm(
        self, data: ExperimentData, model: PairHmmModel
    ) -> list[np.ndarray]:
        """Per-record (refLen, 4) posterior base-expectation matrices
        under one model: the --outputAllPosteriorProbs reduction
        (reference :136-155), binned inside the kernel's backward sweep
        — only the retire stream and the flush cross to the host."""
        device = resolve_device(self.device)
        params = make_kernel_params(model)
        out: list = [None] * len(data.records)
        batch_size = preferred_realign_batch_size(self.batch_size, device)
        # window each global record to its aligned ref span (flanking
        # pure-D runs carry zero posterior aligned-pair mass but cost a
        # DP diagonal per ref base — the --splitMatrixBiggerThanThis
        # analogue, see align.realign.window_global_pair), then bucket
        # by padded WINDOW shapes.  Over-budget windows anchor-split
        # like realign (align.realign.split_window_pair): each segment
        # owns a disjoint ref slice, so segment expectations scatter
        # independently.
        # the budget of the lanes the band is laid into
        split_budget = self.split_k or max_workspace_k(
            padded_width(self.band_width))
        windows: list = [None] * len(data.records)
        # encoded queries, one encode per RECORD (a split read's
        # segments share it)
        enc_cache: dict[int, np.ndarray] = {}

        def enc_query(idx: int) -> np.ndarray:
            a = enc_cache.get(idx)
            if a is None:
                a = enc_cache[idx] = encode(data.records[idx].query)
            return a

        # unit = (record idx, window-relative ref sj0/sj1 and read
        # si0/si1, segment guide); single-unit records are the norm
        units: list = []
        buckets: dict[tuple[int, int], list[int]] = {}
        for idx, rec in enumerate(data.records):
            guide0 = [
                (op, l)
                for op, l in rec.cigar
                if op in (CIG.M, CIG.I, CIG.D)
            ]
            # the window scatter below places expectations at absolute
            # ref coordinates j0:j1 — only valid for chained GLOBAL
            # records (pos 0), mirroring align/realign.realign_records
            if rec.pos != 0:
                raise ValueError("the SNP caller requires chained global "
                                 "records")
            _, guide, j0, j1 = window_global_pair(
                data.ref_codes[rec.rname], guide0
            )
            windows[idx] = (j0, j1, guide)
            m = len(rec.query)
            if (j1 - j0) + m > split_budget:
                segs = split_window_pair(
                    data.ref_codes[rec.rname][j0:j1], enc_query(idx), guide,
                    split_budget,
                )
            else:
                segs = [(0, j1 - j0, 0, m, guide)]
            for seg in segs:
                units.append((idx, *seg))
        for u, (idx, sj0, sj1, si0, si1, sg) in enumerate(units):
            buckets.setdefault(
                (_next_pow2(sj1 - sj0), _next_pow2(si1 - si0)), []
            ).append(u)

        def descriptors():
            for (n_pad, m_pad), idxs in buckets.items():
                for s in range(0, len(idxs), batch_size):
                    yield idxs[s : s + batch_size], n_pad + m_pad

        def build(desc):
            # pack, upload and launch on the prefetch worker pool
            # (overlaps earlier batches)
            sub, k_max = desc
            pairs = []
            for u in sub:
                idx, sj0, sj1, si0, si1, sg = units[u]
                rec = data.records[idx]
                j0, j1, _ = windows[idx]
                x = data.ref_codes[rec.rname][j0 + sj0 : j0 + sj1]
                y = enc_query(idx)[si0:si1]
                pairs.append((x, y, sg))
            return sub, prepared_from_pairs(
                {
                    "device": device,
                    "emit_gamma": False,
                    "emit_exp": True,
                    "exp_threshold": POSTERIOR_THRESHOLD,
                },
                pairs,
                params,
                band_width=self.band_width,
                k_max=k_max,
                prepared_cls=PreparedPosteriors,
            ).launch()

        for sub, prep in prefetched_map(build, descriptors(), depth=2):
            exps = expectations_from_post(
                prep.run(),
                prep.batch.offsets,
                prep.batch.n,
                self.band_width,
            )
            for b, u in enumerate(sub):
                idx, sj0, sj1, si0, si1, _ = units[u]
                rec = data.records[idx]
                j0, j1, _ = windows[idx]
                n_full = len(data.ref_codes[rec.rname])
                if j0 == 0 and j1 == n_full and sj1 - sj0 == j1 - j0:
                    out[idx] = exps[b]
                    continue
                # scatter the segment's expectations into full-ref
                # coordinates (the trimmed flanks carry none; split
                # segments own disjoint ref slices)
                if out[idx] is None:
                    out[idx] = np.zeros((n_full, 4), np.float32)
                out[idx][j0 + sj0 : j0 + sj1] = exps[b]
        return out

    # ------------------------------------------------------------------ #
    def run(self) -> None:
        data = ExperimentData(
            self.read_fastq_file, self.reference_fasta_file, self.sam_file
        )
        rng = np.random.default_rng(self.seed)

        # held-out SNP truth from the mutated-reference index (:61-78)
        snp_set: dict[tuple[str, int], str] = {}
        index_file = self.reference_fasta_file + "_Index.txt"
        if os.path.exists(index_file):
            seqs = read_fasta_dict(index_file)
            for name in seqs:
                if name in data.ref_seqs:
                    true_seq = seqs[name]
                    mutated = seqs[name + "_mutated"]
                    if mutated != data.ref_seqs[name]:
                        raise ValueError(
                            "%s: %s_mutated is not the reference's %s"
                            % (index_file, name, name))
                    for i in range(len(true_seq)):
                        if true_seq[i] != mutated[i]:
                            snp_set[(name, i)] = true_seq[i]

        total_ref_len = sum(len(s) for s in data.ref_seqs.values())
        total_held_out = len(snp_set)
        total_not_held_out = total_ref_len - total_held_out

        # substitution matrices (:56-59)
        null_m = get_null_substitution_matrix()
        flat_m = get_jukes_cantor_matrix()
        hmm20 = PairHmmModel.load(trained_hmm_path("blasr_hmm_20.txt"))
        hmm_err_m = hmm20.error_substitution_matrix()

        models = {
            "cactus": PairHmmModel.default(),
            "trained_0": PairHmmModel.load(trained_hmm_path("blasr_hmm_0.txt")),
            "trained_20": hmm20,
            "trained_40": PairHmmModel.load(
                trained_hmm_path("blasr_hmm_40.txt")
            ),
        }

        # contig -> (start offset, codes) for flat ref-position arrays
        contig_offset: dict[str, int] = {}
        off = 0
        for name, seq in data.ref_seqs.items():
            contig_offset[name] = off
            off += len(seq)
        posteriors_by_hmm = {
            hmm_type: self._posteriors_for_hmm(data, models[hmm_type])
            for hmm_type in HMM_TYPES
        }

        node = ET.Element("marginAlignComparison")
        for hmm_type in HMM_TYPES:
            for coverage in COVERAGES:
                n_reps = 3 if coverage < 1000000 else 1
                for replicate in range(n_reps):
                    self._run_combination(
                        node,
                        data,
                        rng,
                        hmm_type,
                        coverage,
                        replicate,
                        posteriors_by_hmm[hmm_type],
                        snp_set,
                        total_ref_len,
                        total_held_out,
                        total_not_held_out,
                        contig_offset,
                        null_m,
                        flat_m,
                        hmm_err_m,
                    )

        with open(self.out("marginaliseConsensus.xml"), "w") as fh:
            fh.write(pretty_xml(node))

    # ------------------------------------------------------------------ #
    def _run_combination(
        self, node, data, rng, hmm_type, coverage, replicate, posteriors,
        snp_set, total_ref_len, total_held_out, total_not_held_out,
        contig_offset, null_m, flat_m, hmm_err_m,
    ) -> None:
        records = data.records
        order = rng.permutation(len(records))
        total_read_length = 0
        total_aligned_pairs = 0
        sampled: list[int] = []
        for idx in order:
            # integer-division quota check as in py2 (:94)
            if total_read_length // total_ref_len >= coverage:
                break
            rec = records[idx]
            total_read_length += len(data.read_seqs[rec.qname])
            sampled.append(int(idx))

        expectations = np.zeros((total_ref_len, 4))
        frequencies = np.zeros((total_ref_len, 4))
        for idx in sampled:
            rec = records[idx]
            c = data.all_counts[idx]
            goff = contig_offset[rec.rname]
            # aligned-base frequencies (:112-119)
            pq = c.pair_read_codes
            read_pos, ref_pos = rec.aligned_pair_arrays()
            in_bounds = ref_pos < len(data.ref_codes[rec.rname])
            ref_pos = ref_pos[in_bounds]
            total_aligned_pairs += len(ref_pos)
            ok = pq < 4
            np.add.at(
                frequencies,
                (goff + ref_pos[ok], pq[ok]),
                1.0,
            )
            # posterior expectations (:149-155): the device reduction
            # already produced this read's (refLen, 4) matrix
            exp_r = posteriors[idx]
            expectations[goff : goff + exp_r.shape[0]] += exp_r

        # mutated ref base codes over the flat coordinate space
        ref_codes_flat = np.concatenate(
            [data.ref_codes[name] for name in data.ref_seqs]
        )
        # true ref bases (apply held-out SNPs)
        true_codes = ref_codes_flat.copy()
        for (name, pos), base in snp_set.items():
            true_codes[contig_offset[name] + pos] = "ACGT".index(base)

        call_sets = {
            "marginAlignMaxExpectedSnpCalls": (flat_m, null_m, expectations),
            "marginAlignMaxLikelihoodSnpCalls": (hmm_err_m, null_m, expectations),
            "maxFrequencySnpCalls": (flat_m, null_m, frequencies),
            "maximumLikelihoodSnpCalls": (hmm_err_m, null_m, frequencies),
        }

        for tag, (err_m, evo_m, base_exp) in call_sets.items():
            calls = _SnpCalls(total_held_out)
            totals = base_exp.sum(axis=1)
            called = (totals > 0) & (ref_codes_flat < 4)
            # positions never observed count once per strategy (:250-251)
            calls.not_called = int((~called).sum())
            if called.any():
                obs = base_exp[called] / totals[called, None]
                ref_b = ref_codes_flat[called]
                post = calc_base_posterior_probs(obs, ref_b, evo_m, err_m)
                true_b = true_codes[called]
                pos_idx = np.nonzero(called)[0]
                for alt in range(4):
                    mask = ref_b != alt
                    probs = post[mask, alt]
                    is_tp = (true_b[mask] != ref_b[mask]) & (
                        true_b[mask] == alt
                    )
                    calls.tp_probs.extend(probs[is_tp].tolist())
                    calls.fp_probs.extend(probs[~is_tp].tolist())

            recall = calls.recall_by_probability()
            precision = calls.precision_by_probability()
            f_scores = [
                (
                    2 * recall[i] * precision[i] / (recall[i] + precision[i])
                    if recall[i] + precision[i] > 0
                    else 0.0,
                    i,
                )
                for i in range(len(recall))
            ]
            f_score, p_index = max(f_scores)

            total_sampled = max(len(sampled), 1)
            ET.SubElement(
                node,
                tag + "_" + hmm_type,
                {
                    "coverage": str(coverage),
                    "actualCoverage": str(
                        float(total_aligned_pairs) / total_ref_len
                        if total_ref_len
                        else 0.0
                    ),
                    "totalAlignedPairs": str(total_aligned_pairs),
                    "totalReferenceLength": str(total_ref_len),
                    "replicate": str(replicate),
                    "totalReads": str(len(records)),
                    "avgSampledReadLength": str(
                        float(total_read_length) / total_sampled
                    ),
                    "totalSampledReads": str(len(sampled)),
                    "totalHeldOut": str(total_held_out),
                    "totalNonHeldOut": str(total_not_held_out),
                    "recall": str(recall[p_index]),
                    "precision": str(precision[p_index]),
                    "fScore": str(f_score),
                    "optimumProbThreshold": str(float(p_index) / 100.0),
                    "totalNoCalls": str(calls.not_called),
                    "recallByProbability": " ".join(map(str, recall)),
                    "precisionByProbability": " ".join(map(str, precision)),
                },
            )
