"""Consensus analysis: pileup-based consensus FASTQ from the alignments.

Replaces the reference Consensus analysis
(reference nanopore/analyses/consensus.py), which shells through
``samtools mpileup -Q 0 -uf | bcftools view -cg | vcfutils.pl vcf2fq``
(consensus.py:64-72).  A copy of the JAX package's ``analyses/consensus.py``: the pileup is a
vectorised scatter-add of aligned bases per reference position, the
call is the majority base with a phred-like quality from the base-count
margin, and positions with zero coverage keep the reference base at
quality 0 — the informational contract of the vcf2fq consensus without
the external toolchain.  (Default-disabled in the reference pipeline,
pipeline.py:81.)
"""

from __future__ import annotations

import numpy as np

from nanopore_tpu_torch.analyses.base import Analysis
from nanopore_tpu_torch.analyses.common import ExperimentData
from nanopore_tpu_torch.io.encoding import decode
from nanopore_tpu_torch.io.seqio import fastq_write


class Consensus(Analysis):
    def run(self) -> None:
        data = ExperimentData(
            self.read_fastq_file, self.reference_fasta_file, self.sam_file
        )
        pileups = {
            name: np.zeros((len(seq), 4), np.float64)
            for name, seq in data.ref_seqs.items()
        }
        for rec, c in zip(data.records, data.all_counts):
            _, ref_pos = rec.aligned_pair_arrays()
            in_bounds = ref_pos < len(data.ref_codes[rec.rname])
            ref_pos = ref_pos[in_bounds]
            pq = c.pair_read_codes
            ok = pq < 4
            np.add.at(pileups[rec.rname], (ref_pos[ok], pq[ok]), 1.0)

        with open(self.out("consensus.fastq"), "w") as fh:
            for name, pile in pileups.items():
                ref_codes = data.ref_codes[name]
                totals = pile.sum(axis=1)
                best = pile.argmax(axis=1)
                second = np.sort(pile, axis=1)[:, -2]
                margin = pile.max(axis=1) - second
                covered = totals > 0
                call = np.where(covered, best, ref_codes).astype(np.int8)
                # phred-like: 10 * margin capped at 40, 0 where uncovered
                qual = np.clip((10 * margin), 0, 40).astype(int)
                qual[~covered] = 0
                fastq_write(
                    fh,
                    name + "_consensus",
                    decode(call),
                    qual.tolist(),
                )
