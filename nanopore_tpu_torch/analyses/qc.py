"""Read/alignment QC analyses.

Replace the reference's Java tool shims FastQC / QualiMap
(reference nanopore/analyses/{fastqc,qualimap}.py — both
default-disabled): if the external tools exist on PATH they are invoked
with the same CLI; otherwise a native summary report is produced so the
analysis still yields QC output in a hermetic environment.  A copy of
the JAX package's ``analyses/qc.py``.
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np

from nanopore_tpu_torch.analyses.base import Analysis
from nanopore_tpu_torch.analyses.common import ExperimentData
from nanopore_tpu_torch.io.seqio import fastq_read


class FastQC(Analysis):
    def run(self) -> None:
        if shutil.which("fastqc"):
            subprocess.run(
                ["fastqc", self.read_fastq_file, "--outdir=" + self.output_dir],
                check=False,
            )
            return
        lengths, gc, mean_quals = [], [], []
        for _, seq, quals in fastq_read(self.read_fastq_file):
            lengths.append(len(seq))
            if seq:
                gc.append((seq.count("G") + seq.count("C")) / len(seq))
            if quals:
                mean_quals.append(float(np.mean(quals)))
        with open(self.out("fastqc_summary.txt"), "w") as fh:
            fh.write("metric\tvalue\n")
            fh.write("reads\t%d\n" % len(lengths))
            fh.write("totalBases\t%d\n" % int(np.sum(lengths)))
            if lengths:
                fh.write("meanLength\t%.2f\n" % float(np.mean(lengths)))
                fh.write("minLength\t%d\n" % int(np.min(lengths)))
                fh.write("maxLength\t%d\n" % int(np.max(lengths)))
            if gc:
                fh.write("meanGC\t%.4f\n" % float(np.mean(gc)))
            if mean_quals:
                fh.write("meanBaseQuality\t%.2f\n" % float(np.mean(mean_quals)))


class QualiMap(Analysis):
    def run(self) -> None:
        data = ExperimentData(
            self.read_fastq_file, self.reference_fasta_file, self.sam_file
        )
        # skipped when the SAM has no quals, like the reference
        # (qualimap.py:10-14)
        if not any(rec.qual not in ("*", "") for rec in data.records):
            return
        if shutil.which("qualimap"):
            subprocess.run(
                ["qualimap", "bamqc", "-bam", self.sam_file,
                 "-outdir", self.output_dir],
                check=False,
            )
            return
        with open(self.out("qualimap_summary.txt"), "w") as fh:
            fh.write("metric\tvalue\n")
            fh.write("alignments\t%d\n" % len(data.records))
            mapped_bases = sum(c.matches + c.mismatches for c in data.all_counts)
            fh.write("alignedPairs\t%d\n" % mapped_bases)
            if data.all_counts:
                ident = [
                    c.matches / max(c.matches + c.mismatches, 1)
                    for c in data.all_counts
                ]
                fh.write("meanIdentity\t%.4f\n" % float(np.mean(ident)))
