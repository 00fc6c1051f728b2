"""CoverageDepth meta-analysis: per-base depth across the reference.

A copy of the JAX package's ``meta/coverage_depth.py``.

Reproduces the reference's nanopore/metaAnalyses/coverageDepth.py
without the samtools/pysam toolchain: depth per reference position is a
vectorised scatter-add over every alignment's ref-consuming cigar runs
(what ``samtools depth`` reports), mean/SD summarised, and positions
whose depth jumps >= 2 standard deviations from the previous position
are flagged with their preceding 5-mer context (coverageDepth.py:75-92).
"""

from __future__ import annotations

import os

import numpy as np

from nanopore_tpu_torch.meta.base import MetaAnalysis
from nanopore_tpu_torch.io.sam import SamReader, CIG
from nanopore_tpu_torch.io.seqio import read_fasta_dict


def depth_from_sam(sam_path: str, ref_lengths: dict[str, int]) -> dict[str, np.ndarray]:
    """Per-contig per-position aligned-base depth (M/=/X columns)."""
    depth = {
        name: np.zeros(length + 1, np.int64)
        for name, length in ref_lengths.items()
    }
    for rec in SamReader(sam_path).mapped():
        diff = depth.get(rec.rname)
        if diff is None:
            continue
        pos = rec.pos
        for op, length in rec.cigar:
            if op in (CIG.M, CIG.EQ, CIG.X):
                end = min(pos + length, len(diff) - 1)
                if pos < end:
                    diff[pos] += 1
                    diff[end] -= 1
                pos += length
            elif op in (CIG.D, CIG.N):
                pos += length
    return {name: np.cumsum(diff[:-1]) for name, diff in depth.items()}


class CoverageDepth(MetaAnalysis):
    def run(self) -> None:
        for exp in self.experiments:
            sam_path = os.path.join(exp.experiment_dir, "mapping.sam")
            if not os.path.exists(sam_path):
                continue
            experiment = os.path.basename(exp.experiment_dir)
            ref_seqs = read_fasta_dict(exp.reference_fasta_file)
            reader = SamReader(sam_path)
            depth = depth_from_sam(
                sam_path, {n: len(s) for n, s in ref_seqs.items()}
            )

            depth_path = self.out(experiment + "_Depth.txt")
            all_cov = []
            with open(depth_path, "w") as fh:
                for name, d in depth.items():
                    covered = np.nonzero(d)[0]
                    for pos in covered:
                        # samtools depth is 1-based and skips zero rows
                        fh.write("%s\t%d\t%d\n" % (name, pos + 1, d[pos]))
                    all_cov.extend(d[covered].tolist())
            if not all_cov:
                continue
            all_cov = np.array(all_cov)
            mean_cov = float(np.mean(all_cov))
            sd_cov = float(np.std(all_cov))
            threshold = 2 * sd_cov

            stats_path = self.out(experiment + "_Stats.out")
            with open(stats_path, "w") as fh:
                fh.write(
                    "Position\tCoverage (mu=%sX, sd=%sX)\tKmer\n"
                    % (mean_cov, sd_cov)
                )
                for name, d in depth.items():
                    seq = ref_seqs[name]
                    covered = np.nonzero(d)[0]
                    prev = 0
                    for pos in covered:
                        one_based = pos + 1
                        if d[pos] - prev >= threshold:
                            kmer = (
                                seq[one_based - 5 : one_based]
                                if one_based >= 5
                                else seq[0:one_based]
                            )
                            fh.write(
                                "%d\t%d\t%s\n" % (one_based, d[pos], kmer)
                            )
                        prev = int(d[pos])
            self._plot(experiment, depth)

    def _plot(self, experiment, depth):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, axes = plt.subplots(2, 1, figsize=(10, 6))
            for name, d in depth.items():
                axes[0].plot(d, lw=0.7, label=name)
            axes[0].set_xlabel("reference position")
            axes[0].set_ylabel("depth")
            if len(depth) <= 8:
                axes[0].legend(fontsize=7)
            flat = np.concatenate(list(depth.values()))
            axes[1].hist(flat[flat > 0], bins=40, color="#3b6fb6")
            axes[1].set_xlabel("depth")
            axes[1].set_ylabel("positions")
            fig.tight_layout()
            fig.savefig(self.out(experiment + "_Coverage_Depth.pdf"))
            plt.close(fig)
        except Exception:
            pass
