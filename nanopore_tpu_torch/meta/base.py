"""Meta-analysis framework: cross-experiment aggregation bases.

A copy of the JAX package's ``meta/base.py``.  Reproduces the
reference's nanopore/metaAnalyses/abstractMetaAnalysis.py (experiment
hash keyed (readFastqFile, readType) x reference x mapper, base-mapper
extraction by the ``[A-Z][a-z]*`` regex) and
abstractUnmappedAnalysis.py (the per-read mapped/unmapped database built
by re-reading every FASTQ and mapping.sam).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Optional

from nanopore_tpu_torch.io.sam import SamReader
from nanopore_tpu_torch.io.seqio import fastq_read


def base_mapper_name(mapper_name: str) -> str:
    return re.findall("[A-Z][a-z]*", mapper_name)[0]


class MetaAnalysis:
    """AbstractMetaAnalysis equivalent; experiments are
    nanopore_tpu_torch.pipeline.Experiment objects."""

    def __init__(self, output_dir: str, experiments, analyses: list[str]):
        self.output_dir = output_dir
        self.experiments = experiments
        self.analyses = analyses

        self.experiment_hash: dict[tuple, str] = {}
        self.mappers: set[str] = set()
        self.read_fastq_files: set[tuple[str, str]] = set()
        self.reference_fasta_files: set[str] = set()
        self.read_types: set[str] = set()
        self.base_mappers: set[str] = set()
        for exp in experiments:
            key = (
                (exp.read_fastq_file, exp.read_type),
                exp.reference_fasta_file,
                exp.mapper_name,
            )
            self.experiment_hash[key] = exp.experiment_dir
            self.mappers.add(exp.mapper_name)
            self.read_fastq_files.add((exp.read_fastq_file, exp.read_type))
            self.reference_fasta_files.add(exp.reference_fasta_file)
            self.read_types.add(exp.read_type)
            self.base_mappers.add(base_mapper_name(exp.mapper_name))

    def run(self) -> None:
        raise NotImplementedError

    def out(self, filename: str) -> str:
        return os.path.join(self.output_dir, filename)


@dataclass
class Read:
    """Per-read record of who mapped it (abstractUnmappedAnalysis.py:8-27)."""

    name: str
    seq: str
    read_type: str
    read_fastq_file: str
    map_ref_pairs: Optional[list[tuple[str, str]]]

    @property
    def is_mapped(self) -> bool:
        return self.map_ref_pairs is not None

    def get_map_ref_pairs(self):
        return self.map_ref_pairs or []


class UnmappedMetaAnalysis(MetaAnalysis):
    """Adds the per-read mapped-by-whom DB
    (abstractUnmappedAnalysis.py:29-51)."""

    def __init__(self, output_dir: str, experiments, analyses: list[str]):
        super().__init__(output_dir, experiments, analyses)
        all_reads = {
            (name.split()[0], exp.read_fastq_file, exp.read_type, seq)
            for exp in experiments
            for name, seq, _ in fastq_read(exp.read_fastq_file)
        }
        mapped: dict[tuple[str, str], set[tuple[str, str]]] = {}
        for exp in experiments:
            sam_path = os.path.join(exp.experiment_dir, "mapping.sam")
            if not os.path.exists(sam_path):
                continue
            for rec in SamReader(sam_path).mapped():
                mapped.setdefault(
                    (rec.qname, exp.read_fastq_file), set()
                ).add((exp.mapper_name, exp.reference_fasta_file))

        self.reads: list[Read] = []
        for name, fastq, read_type, seq in all_reads:
            pairs = mapped.get((name, fastq))
            self.reads.append(
                Read(
                    name, seq, read_type, fastq,
                    sorted(pairs) if pairs else None,
                )
            )
