"""Shared experiment-loading helpers for the analyses."""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass
from functools import cached_property

from nanopore_tpu_torch.analyses.stats_core import (
    AlignmentCounts,
    count_alignment,
)
from nanopore_tpu_torch.io.encoding import encode
from nanopore_tpu_torch.io.sam import SamReader, SamRecord
from nanopore_tpu_torch.io.seqio import read_fasta_dict, read_fastq_dict


@dataclass
class ExperimentData:
    """Lazily-loaded view of one experiment's inputs."""

    read_fastq_file: str
    reference_fasta_file: str
    sam_file: str

    @cached_property
    def ref_seqs(self) -> dict[str, str]:
        return read_fasta_dict(self.reference_fasta_file)

    @cached_property
    def read_seqs(self) -> dict[str, str]:
        return read_fastq_dict(self.read_fastq_file)

    @cached_property
    def ref_codes(self) -> dict[str, np.ndarray]:
        return {k: encode(v) for k, v in self.ref_seqs.items()}

    @cached_property
    def sam(self) -> SamReader:
        return SamReader(self.sam_file)

    @cached_property
    def records(self) -> list[SamRecord]:
        return list(self.sam.mapped())

    def counts(self, rec: SamRecord) -> AlignmentCounts:
        return count_alignment(
            rec, self.ref_codes[rec.rname], len(self.read_seqs[rec.qname])
        )

    @cached_property
    def all_counts(self) -> list[AlignmentCounts]:
        return [self.counts(rec) for rec in self.records]
