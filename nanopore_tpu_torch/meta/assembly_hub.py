"""UCSC assembly-hub generation meta-analysis.

A copy of the JAX package's ``meta/assembly_hub.py``.

Reproduces the reference's nanopore/metaAnalyses/customTrackAssemblyHub.py
(default-disabled there, pipeline.py:83): per reference, build a hub
directory with hub.txt / genomes.txt / groups.txt / trackDb.txt, the
reference as a .2bit (native writer, no faToTwoBit binary), and one
coordinate-sorted BAM track (+ .bai) per experiment via the native BAM
codec — the reference's ``samtools view/sort/index`` chain
(customTrackAssemblyHub.py:93-101) without the binaries.
"""

from __future__ import annotations

import os

from nanopore_tpu_torch.io.bam import sam_to_sorted_bam
from nanopore_tpu_torch.io.seqio import read_fasta_dict
from nanopore_tpu_torch.io.twobit import write_2bit
from nanopore_tpu_torch.meta.base import MetaAnalysis


class CustomTrackAssemblyHub(MetaAnalysis):
    def run(self) -> None:
        for ref in self.reference_fasta_files:
            genome = os.path.basename(ref).rsplit(".", 1)[0]
            hub_dir = self.out("hub_" + genome)
            genome_dir = os.path.join(hub_dir, genome)
            os.makedirs(genome_dir, exist_ok=True)

            seqs = read_fasta_dict(ref)
            write_2bit(seqs, os.path.join(genome_dir, genome + ".2bit"))

            with open(os.path.join(hub_dir, "hub.txt"), "w") as fh:
                fh.write(
                    "hub nanopore_%s\n"
                    "shortLabel nanopore %s\n"
                    "longLabel nanopore_tpu alignments vs %s\n"
                    "genomesFile genomes.txt\n"
                    "email none@example.com\n" % (genome, genome, genome)
                )
            with open(os.path.join(hub_dir, "genomes.txt"), "w") as fh:
                fh.write(
                    "genome %s\n"
                    "twoBitPath %s/%s.2bit\n"
                    "trackDb %s/trackDb.txt\n"
                    "organism %s\n"
                    "defaultPos %s:1-%d\n"
                    "scientificName %s\n"
                    "description nanopore_tpu assembly hub\n"
                    % (
                        genome, genome, genome, genome, genome,
                        next(iter(seqs)), min(10000, len(next(iter(seqs.values())))),
                        genome,
                    )
                )
            with open(os.path.join(genome_dir, "groups.txt"), "w") as fh:
                fh.write(
                    "name map\nlabel Mappings\npriority 2\n"
                    "defaultIsClosed 0\n"
                )
            with open(os.path.join(genome_dir, "trackDb.txt"), "w") as fh:
                for exp in self.experiments:
                    if exp.reference_fasta_file != ref:
                        continue
                    sam = os.path.join(exp.experiment_dir, "mapping.sam")
                    if not os.path.exists(sam):
                        continue
                    track = os.path.basename(exp.experiment_dir)
                    bam = os.path.join(genome_dir, track + ".bam")
                    sam_to_sorted_bam(sam, bam, bam + ".bai")
                    fh.write(
                        "track %s\n"
                        "longLabel %s\n"
                        "shortLabel %s\n"
                        "priority 10\n"
                        "visibility pack\n"
                        "group map\n"
                        "type bam\n"
                        "bigDataUrl %s.bam\n\n"
                        % (track, track, track[:17], track)
                    )
