"""Alignment-uncertainty analysis: posterior rescoring of each alignment.

Counterpart of ``nanopore_tpu/analyses/alignment_uncertainty.py``,
reproducing the reference AlignmentUncertainty
(reference nanopore/analyses/alignmentUncertainty.py): for every record,
rescore the ORIGINAL alignment by its average posterior match
probability under the trained blasr_hmm_0 model (the reference runs
``cactus_realign --rescoreByPosteriorProbIgnoringGaps
--rescoreOriginalAlignment --diagonalExpansion=10
--splitMatrixBiggerThanThis=100 --loadHmm=blasr_hmm_0.txt`` per read,
alignmentUncertainty.py:41-42).  Here each batch of records is packed
on the device and goes through one launch of the realign kernel's gamma
mode (``PreparedPosteriors(emit_gamma=True)``); the rescore of each
record's own cigar is a reduction over the band on the same device
(``ops.posteriors.rescore_from_post``), so only (B,) totals reach the
host.  Runs on the card unless the analysis was given ``device="cpu"``.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.align.realign import _next_pow2
from nanopore_tpu_torch.analyses import plots
from nanopore_tpu_torch.analyses.base import Analysis
from nanopore_tpu_torch.analyses.common import ExperimentData
from nanopore_tpu_torch.device import resolve_device
from nanopore_tpu_torch.io.encoding import encode
from nanopore_tpu_torch.io.sam import CIG
from nanopore_tpu_torch.io.xmlio import pretty_xml
from nanopore_tpu_torch.ops.dispatch import (
    PreparedPosteriors,
    preferred_realign_batch_size,
    prepared_from_pairs,
)
from nanopore_tpu_torch.ops.pack import padded_width
from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
from nanopore_tpu_torch.ops.posteriors import rescore_from_post
from nanopore_tpu_torch.runtime.prefetch import prefetched_map

TRAINED_HMM_DIR = os.path.join(os.path.dirname(__file__), "..", "models")
# The gamma band a batch keeps on its device, (B, k_pad + 1, W) f32, at
# most this many bytes: a global record's window is the whole reference
# (73,728 diagonals on a 48.5 kb one, 9.7 GB for 512 reads at W = 64),
# so a bucket of them runs in smaller batches.  A read's posterior does
# not depend on its batch.
GAMMA_BAND_BYTES = 2 << 30


def trained_hmm_path(name: str = "blasr_hmm_0.txt") -> str:
    """Shipped trained model files (mirrors nanopore/mappers/*.txt)."""
    return os.path.abspath(os.path.join(TRAINED_HMM_DIR, name))


class AlignmentUncertainty(Analysis):
    band_width = 64
    batch_size = None  # ops.dispatch picks (512 on the card)

    def run(self) -> None:
        device = resolve_device(self.device)
        data = ExperimentData(
            self.read_fastq_file, self.reference_fasta_file, self.sam_file
        )
        model_path = trained_hmm_path("blasr_hmm_0.txt")
        model = (
            PairHmmModel.load(model_path)
            if os.path.exists(model_path)
            else PairHmmModel.default()
        )
        params = make_kernel_params(model)

        records = data.records
        buckets: dict[tuple[int, int], list[int]] = {}
        items = []
        for idx, rec in enumerate(records):
            # local coordinates: query vs ref[pos:aend], clip-free cigar
            x = data.ref_codes[rec.rname][rec.pos : rec.aend]
            y = encode(rec.query)
            guide = [
                (op, l) for op, l in rec.cigar if op in (CIG.M, CIG.I, CIG.D)
            ]
            items.append((x, y, guide))
            buckets.setdefault(
                (_next_pow2(len(x)), _next_pow2(len(y))), []
            ).append(idx)

        avg_posteriors = [float("nan")] * len(records)
        batch_size = preferred_realign_batch_size(self.batch_size, device)

        def descriptors():
            for (n_pad, m_pad), idxs in buckets.items():
                k_max = n_pad + m_pad
                step = max(1, min(batch_size, GAMMA_BAND_BYTES // (
                    (k_max + 1) * padded_width(self.band_width) * 4)))
                for s in range(0, len(idxs), step):
                    yield idxs[s : s + step], k_max

        def build(desc):
            # pack, upload and launch on the prefetch worker pool
            # (overlaps earlier batches)
            sub, k_max = desc
            return sub, prepared_from_pairs(
                {"device": device},
                [items[i] for i in sub],
                params,
                band_width=self.band_width,
                k_max=k_max,
                prepared_cls=PreparedPosteriors,
            ).launch()

        for sub, prep in prefetched_map(build, descriptors(), depth=2):
            scores = rescore_from_post(
                prep.run(), prep.batch.offsets, [items[i][2] for i in sub],
                self.band_width,
            )
            for b, i in enumerate(sub):
                avg_posteriors[i] = scores[b]

        aligned_pairs_counts = [
            sum(l for op, l in rec.cigar if op == CIG.M) for rec in records
        ]
        weighted = sum(
            p * a for p, a in zip(avg_posteriors, aligned_pairs_counts)
        )
        node = ET.Element(
            "alignmentUncertainty",
            {
                "averagePosteriorMatchProbabilityPerRead": str(
                    self.format_ratio(sum(avg_posteriors), len(avg_posteriors))
                ),
                "averagePosteriorMatchProbability": str(
                    self.format_ratio(weighted, sum(aligned_pairs_counts))
                ),
                "averagePosteriorMatchProbabilitesPerRead": ",".join(
                    str(v) for v in avg_posteriors
                ),
                "alignedPairsInCigar": ",".join(
                    str(v) for v in aligned_pairs_counts
                ),
            },
        )
        with open(self.out("alignmentUncertainty.xml"), "w") as fh:
            fh.write(pretty_xml(node))
        if avg_posteriors:
            plots.histogram_plot(
                avg_posteriors,
                self.out("posterior_prob_hist.pdf"),
                "avg posterior match probability",
            )
