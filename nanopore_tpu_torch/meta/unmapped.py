"""Unmapped-read meta-analyses: k-mers, length distributions, Venn.

A copy of the JAX package's ``meta/unmapped.py``.  Reproduces the
reference's nanopore/metaAnalyses/
{unmappedKmerAnalysis,unmappedLengthDistributionAnalysis,
comparePerReadMappabilityByMapper}.py over the per-read DB.
"""

from __future__ import annotations

import itertools
import os
from collections import Counter
from math import log

from nanopore_tpu_torch.meta.base import UnmappedMetaAnalysis, base_mapper_name


def _count_kmers(seq: str, k: int) -> Counter:
    """Reference window enumeration (unmappedKmerAnalysis.py:12-17):
    windows ending at i in [k, len) — the final window is skipped."""
    kmers: Counter = Counter()
    for i in range(k, len(seq)):
        s = seq[i - k : i]
        if "N" not in s:
            kmers[s] += 1
    return kmers


class UnmappedKmerAnalysis(UnmappedMetaAnalysis):
    """Mapped-vs-unmapped 5-mer fold change per readType + volcano."""

    kmer_size = 5

    def run(self) -> None:
        k = self.kmer_size
        for read_type in self.read_types:
            mapped_k: Counter = Counter()
            unmapped_k: Counter = Counter()
            for read in self.reads:
                if read.read_type != read_type:
                    continue
                if read.is_mapped:
                    mapped_k += _count_kmers(read.seq, k)
                else:
                    unmapped_k += _count_kmers(read.seq, k)
            mapped_size = sum(mapped_k.values())
            unmapped_size = sum(unmapped_k.values())
            table = self.out(read_type + "_unmapped_kmer_counts.txt")
            with open(table, "w") as fh:
                fh.write(
                    "kmer\tmappableCount\tmappableFraction\t"
                    "unmappableCount\tunmappableFraction\tlogFoldChange\n"
                )
                for kmer_tuple in itertools.product("ATGC", repeat=k):
                    kmer = "".join(kmer_tuple)
                    mf = mapped_k[kmer] / mapped_size if mapped_size else 0
                    uf = (
                        unmapped_k[kmer] / unmapped_size
                        if unmapped_size
                        else 0
                    )
                    if uf == 0:
                        fold = "-Inf"
                    elif mf == 0:
                        fold = "Inf"
                    else:
                        fold = str(-log(mf / uf))
                    fh.write(
                        "\t".join(
                            map(
                                str,
                                [kmer, mapped_k[kmer], mf,
                                 unmapped_k[kmer], uf, fold],
                            )
                        )
                        + "\n"
                    )
            from nanopore_tpu_torch.analyses import plots

            plots.kmer_significance(
                table,
                self.out(read_type + "_unmapped_pval_kmer_counts.txt"),
                self.out(read_type + "_unmapped_top_bot_sigkmer_counts.txt"),
                self.out(read_type + "_volcano_plot.pdf"),
                "Unmapped_Kmer",
            )


class UnmappedLengthDistributionAnalysis(UnmappedMetaAnalysis):
    """Mapped/unmapped read-length lists per readType and per reference
    (unmappedLengthDistributionAnalysis.py)."""

    def run(self) -> None:
        from nanopore_tpu_torch.analyses import plots

        for read_type in self.read_types:
            self._write_pair(
                read_type,
                [r for r in self.reads if r.read_type == read_type],
            )
        for ref in self.reference_fasta_files:
            # reference quirk: the per-reference split ignores the
            # reference entirely (unmappedLengthDistribution...py:24-28)
            self._write_pair(os.path.basename(ref), self.reads)

    def _write_pair(self, label: str, reads) -> None:
        unmapped_path = self.out(label + "_unmapped.txt")
        mapped_path = self.out(label + "_mapped.txt")
        with open(unmapped_path, "w") as uf, open(mapped_path, "w") as mf:
            for read in reads:
                (mf if read.is_mapped else uf).write(
                    "%d\n" % len(read.seq)
                )
        if (
            os.path.getsize(unmapped_path) > 0
            and os.path.getsize(mapped_path) > 0
        ):
            self._plot(label, mapped_path, unmapped_path)

    def _plot(self, label, mapped_path, unmapped_path):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            import numpy as np

            mapped = np.loadtxt(mapped_path, ndmin=1)
            unmapped = np.loadtxt(unmapped_path, ndmin=1)
            fig, ax = plt.subplots(figsize=(6, 4))
            bins = np.histogram_bin_edges(
                np.concatenate([mapped, unmapped]), bins=30
            )
            ax.hist(mapped, bins=bins, alpha=0.6, label="mapped")
            ax.hist(unmapped, bins=bins, alpha=0.6, label="unmapped")
            ax.set_xlabel("read length")
            ax.set_ylabel("reads")
            ax.set_title(label)
            ax.legend()
            fig.tight_layout()
            fig.savefig(self.out(label + "_length_distribution.pdf"))
            plt.close(fig)
        except Exception:
            pass


class ComparePerReadMappabilityByMapper(UnmappedMetaAnalysis):
    """Per-read binary mapper matrix + Venn-style plot
    (comparePerReadMappabilityByMapper.py)."""

    def run(self) -> None:
        for read_type in self.read_types:
            sorted_base = [
                x for x in sorted(self.base_mappers) if x != "Combined"
            ]
            tsv = self.out(read_type + "_perReadMappability.tsv")
            sets: dict[str, set] = {m: set() for m in sorted_base}
            universe: set = set()
            with open(tsv, "w") as fh:
                fh.write("Read\tReadFastqFile\t")
                fh.write("\t".join(sorted_base))
                fh.write("\n")
                for read in self.reads:
                    if read.read_type != read_type:
                        continue
                    universe.add(read.name)
                    flags = {m: 0 for m in sorted_base}
                    if read.is_mapped:
                        for mapper, _ in read.get_map_ref_pairs():
                            bm = base_mapper_name(mapper)
                            if bm in flags and flags[bm] == 0:
                                flags[bm] = 1
                                sets[bm].add(read.name)
                    fh.write(
                        "\t".join(
                            [read.name, os.path.basename(read.read_fastq_file)]
                            + [str(flags[m]) for m in sorted_base]
                        )
                        + "\n"
                    )
            from nanopore_tpu_torch.analyses import plots

            plots.venn_plot(
                sets,
                self.out(read_type + "_perReadMappabilityVennDiagram.pdf"),
                universe=universe,
            )
