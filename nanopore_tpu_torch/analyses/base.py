"""Analysis framework: DONE-marker idempotency protocol.

Replaces the reference's AbstractAnalysis target base
(reference nanopore/analyses/abstractAnalysis.py:5-41): each
analysis owns an output directory, writes a DONE file on success, and is
skipped on resume when DONE exists — the pipeline's checkpoint contract
(SURVEY.md section 5).  A copy of the JAX package's
``analyses/base.py``, with a ``device`` for the analyses that launch
kernels: ``None`` means the card, ``"cpu"`` the plain PyTorch path.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("nanopore_tpu_torch")


class Analysis:
    """Base class; subclasses implement run()."""

    def __init__(
        self,
        read_fastq_file: str,
        read_type: str,
        reference_fasta_file: str,
        sam_file: str,
        output_dir: str,
        device=None,
    ):
        self.read_fastq_file = read_fastq_file
        self.read_type = read_type
        self.reference_fasta_file = reference_fasta_file
        self.sam_file = sam_file
        self.output_dir = output_dir
        self.device = device

    def run(self) -> None:
        raise NotImplementedError

    def execute(self) -> None:
        logger.info(
            "analysis %s: fastq=%s ref=%s sam=%s -> %s",
            type(self).__name__,
            self.read_fastq_file,
            self.reference_fasta_file,
            self.sam_file,
            self.output_dir,
        )
        self.run()
        self.finish()

    def finish(self) -> None:
        open(os.path.join(self.output_dir, "DONE"), "w").close()

    @staticmethod
    def is_finished(output_dir: str) -> bool:
        return os.path.exists(os.path.join(output_dir, "DONE"))

    @staticmethod
    def reset(output_dir: str) -> None:
        if Analysis.is_finished(output_dir):
            os.remove(os.path.join(output_dir, "DONE"))

    @staticmethod
    def format_ratio(numerator: float, denominator: float) -> float:
        """NaN-safe division (abstractAnalysis.py:37-41)."""
        if denominator == 0:
            return float("nan")
        return float(numerator) / denominator

    # ------------------------------------------------------------------ #
    def out(self, filename: str) -> str:
        return os.path.join(self.output_dir, filename)
